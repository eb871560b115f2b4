"""Smoke run of the PyTorch/CUDA port (qeft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and ``nvidia-smi`` name/power limit;
2. build: compiles the CUDA kernels of ``qeft_tpu_torch/csrc`` (nvcc, sm_90a);
3. model: a random packed Llama-2-7B (w4/g128/r128, full width and depth) built
   on the card from a seed; the HBM copy rate measured with a 1 GiB
   device-to-device copy;
4. kernels: K1 and K2 against their plain PyTorch versions at the main path's
   shapes (bf16), with their time, the plain version's time, one PyTorch
   library call's time as a yardstick (never used by the port) and the bound;
   two K1 calls on the same inputs bit-identical (``--only matvec`` runs K1
   at the four stage shapes at M = 1 and 8, with K6 on the same inputs, P4,
   K5 at the OPT-6.7B and Falcon-7b stage shapes and the grouped expert
   matvec (below) alone, after device and build, on random weights, and
   prints its rows without launch counts; with ``--outputs FILE`` it saves
   the K5 and grouped-matvec outputs there, or holds them equal bit for bit
   to the file another checkout's run left);
5. attention: K3 at the S = 64 prefill, the engine's W = 1 windows (B = 8,
   positions 64..191, 200 slots) and windows of S = 512, 2048 (calibration)
   and 4096 (llama2-7b's eval window) without a cache; K4,
   K4q and K8 at the main path's last position, each with its SDPA
   yardstick timed hot (one layer's cache) and rotating over a 32-layer
   cache; K4's grouped-head path at Falcon-7b's batch of 8 (71 over 1,
   2048 slots) and Falcon-40b's 128 over 8, timed at four positions beside
   the families' plain attention over the whole cache that it replaced;
   the latent decode attention at the deepseek-v2-lite.batch64 cell's
   shape (B = 64, 16 heads over 1280 rows of 576), checked at ten positions
   and timed at three beside its bound;
   K4, K4q, K8 and the latent kernel each one CUDA kernel a call in the
   profiler
   (``--only attention`` runs this phase alone, after device and build, and
   prints its rows with the profiler's kernels a call in place of launch
   counts, since no main path runs);
6. probes: P2 (dma_only, unpack_only), P3 (dma_tile at bn 256, 512, 1024)
   and P4 (gemv_ablation, nine variants at the down and qkv shapes) against
   their plain versions, timed hot (one buffer) and cold (rotating over
   copies past 200 MB), with K6 and K1 at P4's shapes; unpack_only beside
   the issue bound of its hot loop (instructions a word from the SASS of the
   built library); ``--only probes`` runs this phase alone after device and
   build, and with ``--parent <checkout>`` times that checkout's P2 and P3
   in a subprocess before and after this one's (its rows without launch
   counts, no contract line);
7. main path: ``generate`` -- prefill 64 tokens, greedy-decode 256 over a
   320-slot bf16 cache, the decode loop as replays of one captured CUDA
   graph -- with launch counts checked per kernel, then the per-token
   protocol of ``main.benchmark``;
8. profile: device busy time and idle share of an eager decode step and of
   the prefill, with the kernels that take it (torch.profiler);
9. oracle: the same model dequantized into a dense bf16 model that runs plain
   PyTorch; the generated tokens teacher-forced through both paths (max logit
   difference per step, bounded), PPL of both on synthetic windows, greedy
   agreement;
10. train kernels: K7 (transposed INT4 GEMM of the backward) and K2 at the
   training shapes (M = 4 x 512 rows) against their plain versions, timed
   beside their bounds and a ``torch.matmul`` yardstick, each one's share of
   its bound printed; both again at a ragged M = 2047;
11. train grad: the autograd linear's ``dx`` and ``dow`` on the full upgate
   stage against autograd through the plain version in f32;
12. train oracle: loss and weak-column gradients of one 4 x 512 batch through
   the kernel path and through the dense bf16 model, layers 0, 15 and 31;
13. train: the WCT main path -- 6 ``make_train_step`` steps at full depth with
   run_finetune's defaults -- with launch counts checked per step, step
   times, tokens/s, peak memory and the device's idle share;
14. cli: ``run_finetune`` (save at step 2, resume to 4) and ``main --load
   wct_final --eval --benchmark`` on a 4-layer model of full width, written
   with ``save_packed``; the tuned model is served through K1-K4;
14b. import (after the training oracle): the first 2 layers of the random
   packed Llama-2-7B written as a reference (xvyaward/qeft) checkpoint with
   ``torch.save``, imported on the card (codes bit-exact, float values
   wherever fp16 holds them), ``generate`` 64 + 64 greedy tokens equal to
   the source's through the graph, a WCT overlay on its slabs, the
   ``import_reference`` CLI and ``main --load --eval`` as subprocesses;
15. serving kernels: K6 (the tensor-core decode matvec) against its plain
   version, timed at M = 1, 4 and 8 with its share of the bound and the
   library's time;
16. int8 generate: 64 + 256 greedy over an int8 cache (K4q 32 x 255 times),
   teacher-forced through the bf16-cache path;
17. stacked generate: the same with QEFT_ATTN_STACKED=1 over bf16 and int8
   caches (K8 32 x 255 times, K4 and K4q never);
18. graph: P1 (``probes.entry_overhead``) -- [A] the cost of one kernel
   entry eagerly and in a graph, [A2] add_one against torch.add in a graph
   as ABAB pairs, [A3] the eager entry's parts on the host clock, [B] each
   K1 stage in a graph, [C] the
   decode step as graph replays and as the eager loop -- then each Llama
   ``generate`` above against the eager loop (tokens identical), with the
   graph step's host clock, busy time and idle share (OPT-6.7B and the
   families likewise in their phases);
19. engine: over bf16 and int8 caches, one counted serve of
   ``measure_engine_throughput``'s default requests (8 slots, 16 requests of
   64 + 128, burst 16) -- the measurement; launches per tick, every request
   checked against the single-sequence path -- and a profiled burst with
   K3's share of the tick;
20. spec: ``SpecEngine`` with an 8-layer self-draft (gamma 4) over the same
   requests and ``speculative_generate_batched`` at B = 4, checked against
   the target's greedy choice under teacher forcing;
21. serving cli: ``run_benchmark --method engine`` and ``--method
   spec-batch --draft_layers 8``;
22. opt model: the Llama model freed, a random packed OPT-6.7B (w4/g128/r128,
   full width and depth) built on the card;
23. family kernels: K5 (the unstacked decode matvec) against its plain version
   at the six OPT-6.7B stage shapes, M = 1 and 8, with and without bias,
   timed beside its bound and ``torch.addmm`` on a pre-dequantized weight;
   K5 on a round-to-nearest packed llama2-7b lm_head (4096 -> 32000, M = 1
   and 8) beside ``torch.mm``; every linear of layer 0 with its bias through K5 (M = 1) and K2 (M = 64);
   K1 and K6 at M = 8 for K = 13,824, 16,384 and 28,672 (28,672: two
   staging chunks a split);
24. opt: ``generate`` -- prefill 64 + 256 greedy over a 320-slot bf16 cache --
   with launch counts checked (K5 for every decode linear, K2 for the
   prefill, nothing else), a profiled decode step and prefill, and the
   dense-model oracle (teacher-forced logits, greedy agreement);
25. families: Phi-2, Bloom-7b1 (per-linear ``reorder_ids``) and Falcon-7b
   (g = 64) at full width and 2 layers: every linear of layer 0 on its
   gathered input, with its bias, through K5 (M = 1) and K2 (M = 64)
   against the plain versions; prefill 64 + 32 greedy each, launch counts
   and the dense-model oracle;
25b. deepseek: the grouped expert matvec (``qgemv_moe``) at one expert
   layer of the deepseek-v2-lite.batch64 cell's decode (64 tokens top-6
   over 64 experts, gate/up 2048 -> 2816 and down 1408 -> 2048) against its
   plain version, timed beside its bound; then DeepSeek-V2-Lite at full
   size built on the card and ``generate`` (64 prompts of 128 + 32 greedy
   over the cell's 1280-slot latent cache) with its prefill counted alone
   and the decode steps' launches checked (``qgemv_moe`` twice an expert
   layer, the latent kernel once a layer, K2 for each dense linear), its
   tokens equal to the eager loop's (``--only deepseek`` runs this phase
   alone after device and build, with the latent kernel's rows);
26. family cli: ``main --load <2-layer OPT-6.7B> --eval --benchmark 64`` and
   ``run_benchmark --method qeft --load`` as two subprocesses run together;
27. quantize: QEFT's quantizer at full Llama-2-7B width, 2 layers of random
   bf16 weights built on the card: extraction (r = 128) and GPTQ-OWQ with
   the global reorder (w4, g = 128, MSE grid) on 16 synthetic crops of
   2048 tokens, K3 in every calibration forward (launches checked);
   the GPTQ column blocks replayed from captured programs; block 0's time
   by step, each linear's GPTQ captured and eagerly (bit-identical), and
   the profiler over q's column loop both ways (device busy time against
   the host clock a column); save_fake, pack_model (fused stages),
   save_packed and both loads, bit for bit; the reference's oracle, fake-quant PPL against packed PPL (2
   windows of 2048, relative delta within 0.1 %), teacher-forced logits of
   the packed model against the fake one, and ``generate`` (64 + 256) from
   the packed checkpoint through the graph, tokens equal to the eager
   loop's, with the dense head (K1-K4) and with QEFT_QUANT_LMHEAD=1 (K5
   for the head); seconds for extraction, each block and packing, and the
   phase's peak device memory;
28. quantize cli (in a thread beside family quantize: subprocesses only):
   ``extract_outidx``, ``main`` quantizing with ``--fake
   --packing --save`` and its fake-vs-packed oracle, ``convert`` and ``main
   --load --eval --benchmark --eval_datasets synthetic,<.npy> --logfile``
   (the line's keys checked) as subprocesses on ``tiny-v2``;
29. family train (after opt, on its model): WCT of OPT-6.7B at full width
   and depth -- 6 steps with run_finetune's defaults, K2 and K7 counted
   per step against the layer structure (K2 twice a linear, K7 once but
   for layer 0's q, k and v), step time, tokens/s, peak memory, idle share
   -- and the training oracle (layers 0, 15 and 31): the loss against the
   dense bf16 model, each weak-column gradient against the dense f32 model
   no farther than the dense bf16 model's; then 2 steps of a 2-layer
   Bloom-7b1 packed without the global reorder (the ``reorder_ids`` gather
   differentiated on the card);
30. family train kernels: K2 and K7 at M = 4 x 512 at the family shapes
   (Falcon-7b qkv and fc1 at g = 64, Phi-2 fc1, OPT-6.7B fc2) against their
   plain versions, timed beside their bounds and ``torch.matmul``;
31. family quantize (after quantize cli): QEFT's quantizer at full width on
   random bf16 weights -- OPT-6.7B (g = 128), Phi-2, Bloom-7b1 (with and
   without the global reorder) and Falcon-7b (g = 64, percdamp 1.0) at 1
   layer, 8 synthetic crops of 2048 tokens (the phase's cut of
   the calibration set), r = 128 -- with seconds for extraction, each block
   and packing, peak memory, the packed checkpoint written and served, the
   oracle (recovered fake vs packed PPL within 0.1 %, the true fake delta
   printed), teacher-forced logits against the fake model and graph tokens
   equal to the eager loop's;
32. hf: a Hugging Face directory of OPT-6.7B at full width and 1 layer (two
   shards and an index) written from the preset's tree and read back bit
   for bit, then ``extract_outidx --model <dir>`` and ``main --model <dir>
   --reorder --packing --eval`` as subprocesses, in a thread beside
   stream-equal;
33. stream-equal: one random f32 tree of Llama-2-7B width at 1 layer,
   quantized held in host memory (blocks streamed to the card) and on the
   card: weak set, fake trees, states, packed codes, scales and slabs
   bit-identical, packed checkpoints byte-equal, ``eval_ppl_streamed``
   within 1e-4 of ``eval_ppl``;
34. stream-70b: ``llama2-70b`` at full width and 2 layers, a random f32
   tree in host memory (9.0 GB): extraction, the captured GPTQ,
   ``reorder_model_host`` and the streamed pack, one block on the card at
   a time (each block's seconds and device peak; a later peak 10 % over
   the first's fails), ``generate`` 64 + 64 through K1-K4 (GQA 64 / 8),
   the oracle, and ``eval_ppl_streamed`` of the host fake tree against
   ``eval_ppl`` of it on the card;
35. parallel (after import, on the Llama-2-7B): K1 and K6 at the stage
   shapes one rank runs (7B at tp 2 from rank 0's shards: down's 43 groups;
   70B width at tp 4: qkv 8192 -> 2560, upgate 8192 -> 14,336, o and down
   without a slab) against their plain versions, timed beside their bounds
   and ``torch.matmul``; then two ranks on the card (``parallel.multihost.
   launch_ranks``, the kernels built here first; Gloo through pinned host
   memory, since NCCL refuses two ranks on one card): the time of one
   psum, ``tp_generate`` at tp 2 (64 + 16 greedy, 320 slots, bf16 and int8
   caches), ``Engine(mesh)`` at tp 2 (the engine's 16 requests, 8 new
   tokens each), ``pp_generate`` at pp 2 (batch 4 in 2 microbatches, 64 +
   16), ``llama_prefill_sp`` at sp 2 over S = 2048 and 16
   ``llama_decode_step_sp`` steps, ``MultiHostEngine`` over the two ranks
   as dp replicas; every rank's launches checked per token and layer, its
   decode step's host clock and device busy time printed (the collectives
   host-staged: no speed result), every output held against the
   single-device path here (teacher-forced logits within ORACLE_RTOL of the
   logit scale; the replicas' tokens equal to the engine phase's); then
   ``run_benchmark --tp 2`` (engine and qeft) as subprocesses;
36. parallel4: four ranks on the card: ``tp_generate`` at tp 4 on 2 layers
   of Llama-2-70B width (16 query over 2 kv heads a rank) and
   ``tppp_generate`` at pp 2 x tp 2 on the Llama-2-7B (batch 2), 64 + 16
   each, checked the same way;
37. tp-train (after parallel4): K2 and K7 at the shard shapes one rank of
   tp-2 training runs (Llama-2-7B width, 512 rows: qkv 4096 -> 6144, upgate
   4096 -> 11,008, o 2048 -> 4096 and down 5504 -> 4096 without a slab)
   against their plain versions, timed beside their bounds and
   ``torch.matmul``; then two ranks on the card train the weak columns of
   4 layers at tp 2 (``parallel.tp_train``) on one batch of 2 x 512: the
   loss and every slab's gradient against the single-device ``wct_loss``
   backward here (the loss within LOSS_RTOL, each slab within TP_GRAD_FRO
   relative and ORACLE_RTOL of its scale), the same with the own-slice
   gather backward planted (it must fail), and 3 steps of
   ``make_tp_train_step`` with K2 and K7 counted per rank and step;
38. dryrun: ``multihost_dryrun`` as 2 hosts x tp 2 = 4 ranks at Llama-2-7B
   width and 2 layers: 2 WCT steps of 1 x 512 on each host's rows (losses
   equal everywhere), the dp-sharded decode against the full-batch
   reference and MultiHostEngine against the single-process engine;
39. unfused: 4 layers of Llama-2-7B width packed without the global
   reorder and unfused (every linear its own ``reorder_ids``): ``generate``
   64 + 64 through the graph and eagerly (tokens equal), K5 counted 7 times
   a layer and token, teacher-forced against the dense model; then 16
   tokens under QEFT_GEMV_F32W=0 (K5's bf16w variant);
40. ablations: ``run_benchmark --method qeft-x`` (no K1/K2/K5/K6/K7 launch)
   and the Llama-2-7B's logits under QEFT_PALLAS=0 teacher-forced against
   the kernel path's; the bf16w variants of K1, K6 and K5 at the four stage
   shapes (M = 1) against their plain versions (and, by the mean |diff|,
   much nearer them than the default kernels are), timed beside the default
   kernels, and on ``generate`` (K1's; K6's with QEFT_FUSED_DECODE=0 too);
   one ``utils.profile_trace`` of graph-replayed decode steps, its trace
   naming K1's kernel.

Each main path runs with the launch counts set to 0 just before it and read
just after; a kernel's ``launches`` in the JSON table sums its paths (by
path under ``launches_by_path``).  Before the last line it prints the
kernel table as one JSON object and the ``nvidia-smi`` line; the last line
is {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

# the data-sheet peaks, the bound and the CUDA-event timer the probes use
from qeft_tpu_torch.probes.common import PEAK_BF16, PEAK_HBM, bound_ms, time_ms
# environment variables set for a block (the port's gates and flags read),
# restored after it
from qeft_tpu_torch.env import setting as environ

PROMPT, NEW_TOKENS = 64, 256
CACHE = PROMPT + NEW_TOKENS
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6  # run_finetune's defaults
ORACLE_LAYERS = (0, 15, 31)
LOSS_RTOL = 1e-2  # of the dense loss; see phase_train_oracle()
KERNEL_RTOL = 1e-2  # of max |plain|; see check()
ORACLE_RTOL = 0.1  # of max |dense logit|; see phase_oracle()
VARIANT_SHARE = 0.25  # of the default kernel's mean distance; see check_variant()
GRAD_RATIO = 1.25  # of the dense bf16 model's gradient error; see phase_family_train_oracle()
# K7 faults the oracle is read with: dx scaled by each; the first must fail it
FAULTS_DX = (0.8,)  # 0.95 and 0.99 were cut for the time budget (PERF.md section 4)
# measure_engine_throughput's defaults; the self-draft of run_benchmark's example
ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_CTX, ENGINE_GEN = 8, 16, 64, 128
# tokens of each eager decode loop held against a graph-run generate, and of
# the serving-cli runs (cut from 256 and 128 for the time budget)
GRAPH_EAGER_TOKENS, SERVING_CLI_GEN = 64, 64
SPEC_DRAFT_LAYERS = 8
OPT_LINEARS = ("q", "k", "v", "o", "fc1", "fc2")
# K5's stage shapes (label, K, N, group size, calls a decode layer, token
# rows): OPT-6.7B's q/k/v/o, fc1 and fc2 at M = 1 and 8, Falcon-7b's qkv, o,
# fc1 and fc2 (g = 64) at M = 8, as chat-b1 and batch8 run them
K5_STAGES = (("opt-6.7b q/k/v/o", 4096, 4096, 128, 4, (1, 8)),
             ("opt-6.7b fc1", 4096, 16384, 128, 1, (1, 8)),
             ("opt-6.7b fc2", 16384, 4096, 128, 1, (1, 8)),
             ("falcon-7b qkv", 4544, 4672, 64, 1, (8,)),
             ("falcon-7b o", 4544, 4544, 64, 1, (8,)),
             ("falcon-7b fc1", 4544, 18176, 64, 1, (8,)),
             ("falcon-7b fc2", 18176, 4544, 64, 1, (8,)))
WIDE_K = (13824, 16384, 28672)  # llama2-13b / OPT-6.7B fc2 / 70B down
# the decode stages of a Llama layer: (name, RMS norm before it, residual after it)
K1_STAGES = (("qkv", True, False), ("o", False, True), ("upgate", True, False),
             ("down", False, True))
# (family, preset, group size, global reorder) of the 2-layer family runs
FAMILY_RUNS = (("phi", "phi-2", 128, True), ("bloom", "bloom-7b1", 128, False),
               ("falcon", "falcon-7b", 64, True))
FAMILY_LAYERS, FAMILY_NEW = 2, 32
# K4's grouped-head path at the falcon-7b.batch8 cell's shape: batch, query
# heads over one kv head, cache slots, and the positions timed
GROUP_B, GROUP_HEADS, GROUP_SLOTS = 8, 71, 2048
GROUP_POSITIONS = (256, 700, 1280, 2047)
# the deepseek-v2-lite.batch64 cell's decode: batch, latent cache slots and
# the positions its latent kernel is timed at; the deepseek phase's
# generate: prompt and new tokens a sequence over the cell's cache
DS_BATCH, DS_SLOTS = 64, 1280
DS_POSITIONS = (256, 700, 1279)
DS_PROMPT, DS_NEW = 128, 32
HF_LAYERS = 1  # the hf phase's OPT-6.7B directory (cut from 2 for the time budget)
# K3 windows without a cache: eval_ppl at 512, the calibration length, llama2-7b's context
FULL_WINDOWS = (512, 2048, 4096)
# the quantize phase: llama2-7b at full width, its depth cut to QUANT_LAYERS;
# QUANT_SAMPLES calibration crops of QUANT_SEQ tokens, the oracle over
# QUANT_EVAL_WINDOWS windows of QUANT_SEQ; PPL_RTOL bounds the relative
# fake-vs-packed PPL delta (the reference's oracle; it recorded 0.04 % at 13B)
QUANT_PRESET, QUANT_LAYERS, QUANT_SAMPLES, QUANT_SEQ, QUANT_EVAL_WINDOWS = (
    "llama2-7b", 2, 16, 2048, 2)  # 32 crops before the time budget's cut
PPL_RTOL = 1e-3
QUANT_CLI_PRESET = "tiny-v2"
# the family-quantize phase: (family, preset, layers, group size, global
# reorder), full width, the depth cut to the layers; FAMILY_QUANT_SAMPLES
# calibration crops of QUANT_SEQ tokens (the reference's protocol takes 128);
# FAMILY_QUANT_NEW greedy tokens after the 64-token prompt
FAMILY_QUANT_RUNS = (("opt", "opt-6.7b", 1, 128, True), ("phi", "phi-2", 1, 128, True),
                     ("bloom", "bloom-7b1", 1, 128, True), ("bloom", "bloom-7b1", 1, 128, False),
                     ("falcon", "falcon-7b", 1, 64, True))
FAMILY_QUANT_SAMPLES, FAMILY_QUANT_NEW = 8, 64
# (label, K, N, group size) of the family linears K2 and K7 are timed at for
# training: Falcon-7b's qkv and fc1 (K = 4544 = 71 groups of 64), Phi-2's
# fc1, OPT-6.7B's fc2
FAMILY_SHAPES = (("falcon-7b qkv", 4544, 4672, 64), ("falcon-7b fc1", 4544, 18176, 64),
                 ("phi-2 fc1", 2560, 10240, 128), ("opt-6.7b fc2", 16384, 4096, 128))
# models larger than the card: stream (a) quantizes STREAM_A_LAYERS layers of
# llama2-7b width twice (host-streamed and on the card) on STREAM_A_SAMPLES
# crops, a cut of the calibration set (equality needs no more); stream (b)
# STREAM_B_LAYERS layers of llama2-70b width held in host memory on
# QUANT_SAMPLES crops, generating STREAM_NEW tokens (2 layers, not 4: a
# 70B-width block takes 34-35 s on an H100 80GB HBM3 at 700 W, and at 4 the
# whole run took 956 s, over its 900 s budget); a later block's device peak
# may exceed the first's by STREAM_PEAK_GROWTH; eval_ppl_streamed within
# STREAM_EVAL_RTOL of eval_ppl (qeft_tpu's own bound, tests/test_eval.py:67)
STREAM_A_LAYERS, STREAM_A_SAMPLES = 1, 8
STREAM_B_LAYERS, STREAM_NEW = 2, 64
STREAM_PEAK_GROWTH, STREAM_EVAL_RTOL = 0.10, 1e-4
# the parallel phases (ranks sharing the card): PAR_NEW greedy tokens after
# the PROMPT-token prompt for tp, pp and tp x pp, TP_ENGINE_GEN for each of
# the engine's requests on the tp mesh (every rank's decode step waits on
# 4 host-staged Gloo collectives a layer, about a millisecond each at 2
# ranks on the H100 machine: the token counts are cut to keep the whole run
# in its time budget, PERF.md section 4); pp at PP_BATCH rows in PP_MICRO
# microbatches; sp over SP_SEQ tokens (the calibration length), then
# SP_DECODE decode steps, its prefill logits compared every SP_ROW_STRIDE-th
# row; tp 4 on TP70_LAYERS layers of llama2-70b width (the depth of
# stream-70b); tp x pp at TPPP_BATCH rows; the run_benchmark --tp
# subprocesses generate TP_CLI_GEN tokens a request; GLOO_PROBES collectives
# timed on each rank
PAR_NEW, TP_ENGINE_GEN, PP_BATCH, PP_MICRO = 16, 8, 4, 2  # 32, 16 before the cut
SP_SEQ, SP_DECODE, SP_ROW_STRIDE = 2048, 16, 64  # 4096 before the cut
TP70_LAYERS, TPPP_BATCH, TP_CLI_GEN, GLOO_PROBES = STREAM_B_LAYERS, 2, 8, 50
# phase tp-train: two ranks, 4 layers of Llama-2-7B width, 2 x 512 a step;
# K2 / K7 timed at the rank's shard shapes at 512 rows
TP_TRAIN_LAYERS, TP_TRAIN_BATCH, TP_TRAIN_STEPS, TP_TRAIN_ROWS = 4, 2, 3, 512
TP_TRAIN_SHARDS = (("qkv", 4096, 6144, 128), ("upgate", 4096, 11008, 128),
                   ("o", 2048, 4096, 0), ("down", 5504, 4096, 0))
# of a slab gradient's norm: the tp path against the single device 1.0-1.8 %,
# each bf16 path against f32 1.3-2.3 %, the planted own-slice gather
# backward 20-28 % on every qkv slab (PERF.md section 6)
TP_GRAD_FRO = 0.05
DRYRUN_LAYERS = 2
UNFUSED_LAYERS, UNFUSED_NEW, UNFUSED_F32W = 4, 64, 16
ABLATION_GEN = 16
SERVED: dict = {}  # the engine phase's served tokens, by cache
# the import phase: the first IMPORT_LAYERS layers of the random packed
# llama2-7b as a reference checkpoint, IMPORT_NEW greedy tokens
IMPORT_LAYERS, IMPORT_NEW = 2, 64
# profiler sessions tried for a call's kernels before an empty record stands
PROFILE_ATTEMPTS = 3
# the linears of the quantize phase's block 0 whose GPTQ is run eagerly
# (graph=False) beside the captured run, and held bit-identical to it
BREAKDOWN_EAGER = ("q", "down")
PATH_LAUNCHES: dict = {}  # launch counts of each main path, by path
# the decode matvecs' outputs at their stage shapes, by label, each with its
# split count (--outputs)
OUTPUTS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_times(prof, per: int = 1):
    """(name, device ms) of each CUDA kernel a torch.profiler run recorded,
    divided by ``per``, longest first, and their sum."""
    kernels = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / per)
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    kernels = sorted((k for k in kernels if k[1] > 0), key=lambda k: -k[1])
    return kernels, sum(ms for _, ms in kernels)


def f32(t):
    """``t`` (a tensor, a packed linear or None) with float leaves in f32."""
    from qeft_tpu_torch.ops.packing import QLinearParams

    if isinstance(t, QLinearParams):
        return t.map(f32)
    return t.float() if t is not None and t.is_floating_point() else t


def check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel output (bf16) against the plain version evaluated in f32 on the
    same inputs.  Tolerance KERNEL_RTOL of the output's scale (max |plain|):
    the kernels sum in f32 and round to bf16 only their output and, in K1/K2,
    the normalised activations and dequantized weights -- each a relative
    error near 2**-9 -- while a wrong index or a lost term moves outputs by
    the scale itself."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = torch.isfinite(got.float()).all().item() and err <= KERNEL_RTOL * scale
    log(f"  {name}: max_abs_err {err:.5g} (scale {scale:.5g}, tol {KERNEL_RTOL * scale:.5g})"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_variant(name: str, got: torch.Tensor, want: torch.Tensor,
                  default: torch.Tensor) -> tuple:
    """A kernel variant that changes only a rounding (bf16w): `check`'s
    bound is ordinary bf16 noise, which that rounding also is, so the
    default kernel, what a variant that ignored its flag would give, passes
    it too.  Here the variant's output must sit much nearer its plain
    version ``want`` than the default kernel's output ``default`` does, by
    the mean |diff|: the max is one bf16 step of the largest outputs
    wherever two f32 sums straddle a rounding boundary, while the weights'
    rounding moves nearly every output.  -> (mean |got - want|, mean
    |default - want|); fails unless the first is under VARIANT_SHARE of the
    second."""
    err = (got.float() - want.float()).abs().mean().item()
    gap = (default.float() - want.float()).abs().mean().item()
    ok = err < VARIANT_SHARE * gap
    log(f"  {name}: mean |kernel - its plain| {err:.4g}, mean |default kernel - that plain| "
        f"{gap:.4g} (ratio {err / gap if gap else float('inf'):.3g}, must be under "
        f"{VARIANT_SHARE}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the variant is no nearer its plain version than the "
                             f"default kernel is")
    return err, gap


class Row:
    """One kernel's entry of the JSON table, summed over its shapes."""

    def __init__(self, name, source, replaces, library):
        self.d = dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                      max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
                      library_ms=0.0 if library else None, bound_ms_measured_hbm=0.0, per="")

    def add(self, err, ms, plain, library, nbytes, flops, bw):
        """One shape: its error, kernel/plain/library times and its bound
        (from the data-sheet peaks, and from the copy rate measured here)."""
        d = self.d
        bound, by = bound_ms(nbytes, flops)
        d["max_abs_err"] = max(d["max_abs_err"], err)
        d["ms"] += ms
        d["plain_ms"] += plain
        d["bound_ms"] += bound
        d["bound_by"] = by
        d["bound_ms_measured_hbm"] += nbytes / bw * 1e3
        if library is not None:
            d["library_ms"] += library
        return bound, by


# ---------------------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build():
    from qeft_tpu_torch.ops import cuda_lib

    cuda_lib.load()
    log(f"[build] {len(cuda_lib.SOURCES)} libraries from {cuda_lib.CSRC} into "
        f"{cuda_lib.build_dir()} in {cuda_lib.build_seconds:.1f} s")


def phase_model():
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.testing import build_packed_model

    cfg = LLAMA_PRESETS["llama2-7b"]
    tick = time.perf_counter()
    params = build_packed_model(cfg, seed=0, g=128, r=128, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params["layers"]))
    nbytes += sum(t.numel() * t.element_size() for t in (params["final_ln"], params["lm_head"]))
    log(f"[model] random packed llama2-7b (32 layers, w4/g128/r128) on the card in "
        f"{time.perf_counter() - tick:.1f} s; {nbytes} bytes of layers, final norm and lm_head")
    return cfg, params, nbytes, copy_rate()


def copy_rate() -> float:
    """The card's copy rate (bytes/s, read + write) of a 1 GiB
    device-to-device copy."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda i: dst.copy_(src), inner=5, reps=5)
    bw = 2 * src.numel() / (copy_ms * 1e-3)
    log(f"[model] device-to-device copy of 1 GiB: {copy_ms:.3f} ms -> {bw / 1e9:.1f} GB/s "
        f"(read + write; data-sheet peak {PEAK_HBM / 1e9:.0f} GB/s)")
    return bw


def _leaves(tree):
    from qeft_tpu_torch.ops.packing import QLinearParams

    for v in tree.values():
        if isinstance(v, QLinearParams):
            yield from (t for t in (v.qweight, v.scales, v.scaled_zeros, v.oweight) if t is not None)
        else:
            yield v


def phase_kernels(cfg, params, bw):
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.testing import dense_linear

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    rows = {
        "qgemv_stacked_fused": Row("qgemv_stacked_fused", "qeft_tpu_torch/csrc/qmm.cu",
                                   "qeft_tpu/ops/pallas_qmm.py:439", True),
        "qgemm": Row("qgemm", "qeft_tpu_torch/csrc/qmm.cu", "qeft_tpu/ops/pallas_qmm.py:608", True),
    }
    layers = params["layers"]
    n_layers = cfg.num_layers

    log("[kernels] K1 qgemv_stacked_fused vs plain, M=1, layer rotating over 32 (cold weights)")
    _k1_stages(layers, n_layers, 1, randn, cfg.rms_norm_eps, rows["qgemv_stacked_fused"], bw)
    # gemma numerics: (1 + w) norm scale
    p = layers["qkv"]
    x = randn(2, p.in_features)
    lnw = randn(p.in_features, scale=0.1)
    rows["qgemv_stacked_fused"].d["max_abs_err"] = max(
        rows["qgemv_stacked_fused"].d["max_abs_err"],
        check("K1 qkv one_offset (gemma norm), M=2",
              qmm.qgemv_stacked_fused(x, p, 5, lnw=lnw, eps=1e-6, one_offset=True),
              qmm.qgemv_stacked_fused_plain(f32(x), f32(p), 5, lnw=f32(lnw), eps=1e-6,
                                            one_offset=True)))
    rows["qgemv_stacked_fused"].d["per"] = "one decode layer: qkv + o + upgate + down at M=1"

    log(f"[kernels] K2 qgemm vs plain, M={PROMPT}, layer rotating over 32")
    for name, _, resid in K1_STAGES:
        p = layers[name]
        k, n = p.in_features, p.out_features
        x = randn(PROMPT, k)
        res = randn(PROMPT, n, scale=4.0) if resid else None
        err = check(f"K2 {name} {k}->{n}", qmm.qgemm(x, p.layer(3), residual=res),
                    qmm.qgemm_plain(f32(x), f32(p.layer(3)), residual=f32(res)))
        ms = time_ms(lambda i: qmm.qgemm(x, p.layer(i % n_layers), residual=res))
        plain = time_ms(lambda i: qmm.qgemm_plain(x, p.layer(i % n_layers), residual=res),
                        inner=2, reps=3)
        w = dense_linear(_one_layer(p, 0))[0]
        lib = time_ms(lambda i: torch.matmul(x, w))
        del w
        wbytes = k * n // 2 + 4 * (k // p.group_size) * n + 2 * p.n_outlier * n
        nbytes = wbytes + 2 * PROMPT * (k + n) + (2 * PROMPT * n if resid else 0)
        flops = 2 * PROMPT * (k + p.n_outlier) * n
        b = rows["qgemm"].add(err, ms, plain, lib, nbytes, flops, bw)
        log(f"    kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, torch.matmul on the "
            f"dequantized weight {lib * 1e3:.1f} us, bound {b[0] * 1e3:.2f} us ({b[1]}); the "
            f"kernel at {b[0] / ms:.1%} of its bound")
    d = rows["qgemm"].d
    d["per"] = f"one prefill layer: qkv + o + upgate + down at M={PROMPT}"
    log(f"[kernels] K2 per prefill layer: {d['ms'] * 1e3:.1f} us, bound "
        f"{d['bound_ms'] * 1e3:.2f} us ({d['bound_ms'] / d['ms']:.1%}), torch.matmul "
        f"{d['library_ms'] * 1e3:.1f} us")

    return rows


def _k1_stages(layers, n_layers, m, randn, eps, row, bw, k6=None):
    """K1 at the decode stages in ``layers`` (stacked, ``n_layers`` deep) at
    ``m`` token rows, with the norm (qkv, upgate) or the residual
    (o, down) as the decode layer runs them: each against its plain version
    evaluated in f32 on layer 3, a second call bit-identical, timed rotating
    over the layers (cold weights) beside the plain version, ``torch.matmul``
    on the (normalised) input and a pre-dequantized weight, and the bound,
    summed into ``row``.  With ``k6`` (a dict), K6 on the normalised input
    timed the same way, summed into ``k6[m]``."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.testing import dense_linear

    for name, norm, resid in K1_STAGES:
        if name not in layers:
            continue
        p = layers[name]
        k, n = p.in_features, p.out_features
        x = randn(m, k)
        lnw = (1.0 + randn(k, scale=0.1).float()).to(torch.bfloat16) if norm else None
        res = randn(m, n, scale=4.0) if resid else None
        kw = dict(lnw=lnw, residual=res, eps=eps)
        got = qmm.qgemv_stacked_fused(x, p, 3, **kw)
        err = check(f"K1 {name} {k}->{n} M={m}", got,
                    qmm.qgemv_stacked_fused_plain(f32(x), f32(p), 3, lnw=f32(lnw),
                                                  residual=f32(res), eps=eps))
        if not torch.equal(qmm.qgemv_stacked_fused(x, p, 3, **kw), got):
            raise AssertionError(f"K1 {name} M={m}: a second call on the same inputs differs")
        ms = time_ms(lambda i: qmm.qgemv_stacked_fused(x, p, i % n_layers, **kw))
        plain = time_ms(lambda i: qmm.qgemv_stacked_fused_plain(x, p, i % n_layers, **kw),
                        inner=2, reps=3)
        w = dense_linear(_one_layer(p, 0))[0]
        h = qmm.rms_norm(x, lnw, eps) if norm else x
        lib = time_ms(lambda i: torch.matmul(h, w))
        del w
        wbytes = k * n // 2 + 4 * (k // p.group_size) * n + 2 * p.n_outlier * n
        nbytes = wbytes + 2 * m * (k + n) + (2 * k if norm else 0) + (2 * m * n if resid else 0)
        b = row.add(err, ms, plain, lib, nbytes, 2 * m * k * n, bw)
        line = (f"    {name} M={m}: kernel {ms * 1e3:.1f} us ({b[0] / ms:.1%} of the bound), "
                f"plain {plain * 1e3:.1f} us, torch.matmul on the dequantized weight "
                f"{lib * 1e3:.1f} us, bound {b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B), at "
                f"measured copy rate {nbytes / bw * 1e6:.2f} us")
        if k6 is not None:
            ms6 = time_ms(lambda i: qmm.qgemv_stacked(h, p, i % n_layers))
            k6[m] = k6.get(m, 0.0) + ms6
            line += f"; K6 on the normalised input {ms6 * 1e3:.1f} us"
        log(line)


def phase_matvec(bw, rows):
    """What ``--only matvec`` runs, so that another checkout's matvec
    kernels can be timed in the same call: K1 at the four Llama-2-7B decode
    stages (random stacked w4/g128/r128 weights, as many layers as keep the
    rotation out of L2) at M = 1 and 8, with K6 on the same inputs, then P4
    with its K6 and K1 rows (`_p4_row`), K5 at the OPT-6.7B and Falcon-7b
    stage shapes (`_k5_stage_rows`) and the grouped expert matvec
    (`_moe_matvec_rows`)."""
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.probes import common
    from qeft_tpu_torch.probes import gemv_ablation as p4
    from qeft_tpu_torch.testing import random_packed_linear

    cfg = LLAMA_PRESETS["llama2-7b"]
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    row = rows["qgemv_stacked_fused"] = Row("qgemv_stacked_fused", "qeft_tpu_torch/csrc/qmm.cu",
                                            "qeft_tpu/ops/pallas_qmm.py:439", True)
    m8, k6 = Row("qgemv_stacked_fused", "", "", True), {}
    for name, (k, n) in (("qkv", (hid, qkv)), ("o", (hid, hid)), ("upgate", (hid, 2 * inter)),
                         ("down", (inter, hid))):
        depth = common.n_copies(k * n // 2 + 4 * (k // 128) * n + 2 * 128 * n)
        layers = {name: random_packed_linear(gen, depth, k, n, 128, 128)}
        log(f"[matvec] K1 {name} {k}->{n}, layer rotating over {depth} (cold weights)")
        for m, r in ((1, row), (8, m8)):
            _k1_stages(layers, depth, m, randn, cfg.rms_norm_eps, r, bw, k6)
        del layers
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        row.d[f"m8_{key}"] = m8.d[key]
    row.d["max_abs_err"] = max(row.d["max_abs_err"], m8.d["max_abs_err"])
    row.d["k6_ms"], row.d["m8_k6_ms"] = k6[1], k6[8]
    row.d["per"] = ("one decode layer: qkv + o + upgate + down at M=1 (m8_*: M=8; k6_*: K6 on "
                    "the normalised inputs)")
    log("[matvec] K1 per layer: " + ", ".join(
        f"M={m} {d['ms'] * 1e3:.1f} us (bound {d['bound_ms'] * 1e3:.2f}; torch.matmul "
        f"{d['library_ms'] * 1e3:.1f}; K6 {k6[m] * 1e3:.1f})"
        for m, d in ((1, row.d), (8, m8.d))))
    _p4_row(p4.measure(torch.device("cuda")), rows, bw)
    log("[matvec] K5 at the OPT-6.7B and Falcon-7b stage shapes (random weights, cold)")
    _k5_stage_rows(bw, rows)
    _moe_matvec_rows(bw, rows)


def _k5_stage_rows(bw, rows, stages=K5_STAGES):
    """K5 at its stage shapes (`K5_STAGES`), random w4/r128 weights with a
    bias, as many layers as keep the rotation out of L2: each shape and row
    count against its plain version in f32, a second call bit-identical,
    timed rotating beside its bound (codes, scales, zero points, slab and
    bias once, the rows in and out); the output on layer 0 kept in
    `OUTPUTS`.  Sums per decode layer into the ``qgemv`` row (``stage_us``
    by shape, ``<family>_layer_m<M>_us`` and their bounds)."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.probes import common
    from qeft_tpu_torch.testing import random_packed_linear

    row = rows.setdefault("qgemv", Row("qgemv", "qeft_tpu_torch/csrc/qmm.cu",
                                       "qeft_tpu/ops/pallas_qmm.py:599", False))
    d = row.d
    for label, k, n, g, calls, ms in stages:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(k * 7 + n)
        wbytes = k * n // 2 + 4 * (k // g) * n + 2 * 128 * n + 2 * n
        depth = common.n_copies(wbytes)
        p = random_packed_linear(gen, depth, k, n, g, 128)
        bias = (torch.randn(depth, n, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        lins = [dataclasses.replace(p.layer(i), bias=bias[i]) for i in range(depth)]
        for m in ms:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm.qgemv(x, lins[0])
            if not torch.equal(qmm.qgemv(x, lins[0]), got):
                raise AssertionError(f"K5 {label} M={m}: two calls on the same inputs differ")
            err = check(f"K5 {label} {k}->{n} g={g} M={m}", got,
                        qmm.qgemv_plain(f32(x), f32(lins[0])))
            d["max_abs_err"] = max(d["max_abs_err"], err)
            OUTPUTS[f"K5 {label} M={m}"] = (_splits(-(-n // 256), k // g), got.cpu())
            us = time_ms(lambda i: qmm.qgemv(x, lins[i % depth]), inner=20, reps=9) * 1e3
            bound = bound_ms(wbytes + 2 * m * (k + n), 2 * m * (k + 128) * n)[0] * 1e3
            d.setdefault("stage_us", {})[f"{label} M={m}"] = us
            d.setdefault("stage_bound_us", {})[f"{label} M={m}"] = bound
            key = f"{label.split()[0]}_layer_m{m}"
            d[f"{key}_us"] = d.get(f"{key}_us", 0.0) + calls * us
            d[f"{key}_bound_us"] = d.get(f"{key}_bound_us", 0.0) + calls * bound
            log(f"    K5 {label} M={m}: {us:.2f} us, bound {bound:.2f} us ({bound / us:.1%}); "
                f"{calls} a decode layer; {depth} layers rotating")
        del p, bias, lins
        torch.cuda.empty_cache()
    for key in sorted(k for k in d if "_layer_m" in k and not k.endswith("bound_us")):
        base = key[:-3]
        log(f"[matvec] K5 per {base.replace('_layer_m', ' layer at M = ')}: {d[key]:.1f} us, "
            f"bound {d[base + '_bound_us']:.2f} us ({d[base + '_bound_us'] / d[key]:.1%})")


def _splits(tiles, units):
    """The split count of a decode matvec over ``tiles`` column tiles (x
    experts) and ``units`` groups in the checkout that runs this script: its
    ``qmm.gemv_splits``, or, in a checkout without it, the earlier rule (two
    blocks an SM)."""
    from qeft_tpu_torch.ops import qmm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(qmm, "gemv_splits"):
        return qmm.gemv_splits(tiles, units, sms)
    s = 1
    while 2 * s <= 8 and 2 * s <= units and tiles * 2 * s <= 2 * sms:
        s *= 2
    return s


def _outputs_against(path):
    """`OUTPUTS` saved to ``path``; where ``path`` already holds another
    checkout's (the parent's, run first in the same call), every output the
    two share at the same split count held equal bit for bit instead (a
    different split count sums the splits' tiles in another grouping)."""
    if not os.path.exists(path):
        torch.save(OUTPUTS, path)
        log(f"[outputs] {len(OUTPUTS)} outputs saved to {path}")
        return
    theirs = torch.load(path)
    shared = sorted(key for key in set(theirs) & set(OUTPUTS) if theirs[key][0] == OUTPUTS[key][0])
    for key in sorted(set(theirs) & set(OUTPUTS) - set(shared)):
        log(f"[outputs] {key}: {theirs[key][0]} splits there, {OUTPUTS[key][0]} here: not compared")
    differ = [key for key in shared if not torch.equal(theirs[key][1], OUTPUTS[key][1])]
    log(f"[outputs] {len(shared)} outputs at the same split count held against {path}: "
        f"{len(shared) - len(differ)} equal bit for bit")
    if differ or not shared:
        raise AssertionError(f"outputs differ from {path}'s: {differ or 'none shared'}")


def _kernels_a_call(fn, calls: int = 16):
    """The CUDA kernels that ``calls`` calls of ``fn(i)`` ran, as
    torch.profiler records them after one unprofiled call: (their distinct
    names, kernel records a call).  One kernel a call shows as one name at
    no more than one record a call; the profiler may drop records of short
    kernels, so the records alone do not count the launches."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        if events:
            break
        # a session that recorded no CUDA activity at all measured nothing
        log(f"  the profiler recorded no CUDA kernel in session {attempt + 1}; profiling again")
    return sorted(e.key[:60] for e in events), sum(e.count for e in events) / calls


def _hot_and_rotating(fn, lib_inputs, lib, n_layers):
    """``fn(layer)`` and ``lib(*lib_inputs[layer])`` timed rotating over the
    ``n_layers`` layers, as the decode step reads them, and hot (layer 0
    again and again: one layer's cache stays in the 50 MB L2); every layer's
    library inputs were built before the timing.  Returns (rotating ms,
    rotating library ms, hot ms, hot library ms)."""
    return (time_ms(lambda i: fn(i % n_layers)), time_ms(lambda i: lib(*lib_inputs[i % n_layers])),
            time_ms(lambda i: fn(0)), time_ms(lambda i: lib(*lib_inputs[0])))


def phase_attention_kernels(cfg, bw, rows):
    """K3, K4, K4q and K8 against their plain versions evaluated in f32 at the
    shapes the paths give them, timed beside their bounds and SDPA on the
    same inputs (never called by the port).

    K3 at three shapes: the S = 64 prefill against the 320-slot cache, the
    engine's W = 1 windows (B = 8, one position per sequence in 64..191, 200
    slots; SDPA with a boolean mask) and an S = 512 full window without a
    cache (``eval_ppl``).  K4, K4q and K8 at the last decode position of the
    main path, each with its SDPA yardstick timed hot (one layer's cache
    again and again: it stays in the 50 MB L2) and rotating over the 32
    layers of a cache, as the decode step reads it -- the yardstick's
    per-layer inputs built before the timing; the rotating times are the
    row's.  K4 and K4q also at pos 4095 of 4096 slots (one cache).  Returns the CUDA kernels a call of K4, K4q and K8 takes in the
    profiler."""
    from qeft_tpu_torch.ops import attention, flash

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def int8_cache(*shape):
        codes = torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
        return codes, torch.rand(shape[:-1], generator=gen, device="cuda") * 0.03 + 0.005

    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv, dh, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    rep = hq // hkv
    main_pos = CACHE - 2  # the last decode position of the main path
    src, attn = "qeft_tpu_torch/csrc/decode_attention.cu", "qeft_tpu/ops/pallas_attention.py"
    k3 = rows["flash_window_attention"] = Row(
        "flash_window_attention", "qeft_tpu_torch/csrc/flash.cu", "qeft_tpu/ops/pallas_flash.py:46",
        True)
    k4 = rows["decode_attention"] = Row("decode_attention", src, f"{attn}:62", True)
    k4q = rows["decode_attention_int8"] = Row("decode_attention_int8", src, f"{attn}:86", True)
    k8 = rows["decode_attention_stacked"] = Row("decode_attention_stacked", src, f"{attn}:202",
                                                True)

    def keep_err(row, err):
        row.d["max_abs_err"] = max(row.d["max_abs_err"], err)

    # ---- K3
    log(f"[attention] K3 flash_window_attention vs plain: S={PROMPT} prefill against a "
        f"{CACHE}-slot cache, W=1 engine windows, S=512 full window")
    for label, h, kvh, main in (("llama2-7b heads 32/32", hq, hkv, True),
                                ("GQA heads 32/8", 32, 8, False)):
        q = randn(1, PROMPT, h, dh)
        kc, vc = randn(1, kvh, CACHE, dh), randn(1, kvh, CACHE, dh)
        kc[:, :, PROMPT:] = 0  # slots past the prompt are still empty in prefill
        vc[:, :, PROMPT:] = 0
        err = check(f"K3 S={PROMPT} {label}", flash.flash_window_attention(q, kc, vc, 0),
                    flash.flash_window_attention_plain(f32(q), f32(kc), f32(vc), 0))
        if not main:
            keep_err(k3, err)
            continue
        ms = time_ms(lambda i: flash.flash_window_attention(q, kc, vc, 0))
        plain = time_ms(lambda i: flash.flash_window_attention_plain(q, kc, vc, 0))
        qh = q.transpose(1, 2)  # SDPA gets the kv heads expanded, outside the timing
        kh, vh = (t[:, :, :PROMPT].repeat_interleave(h // kvh, 1) for t in (kc, vc))
        lib = time_ms(lambda i: sdpa(qh, kh, vh, is_causal=True))
        nbytes = 2 * (2 * PROMPT * h * dh + 2 * kvh * PROMPT * dh)
        flops = 4 * h * dh * PROMPT * (PROMPT + 1) // 2
        b = k3.add(err, ms, plain, lib, nbytes, flops, bw)
        log(f"    S={PROMPT}: kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.1f} us, SDPA (causal, "
            f"valid prefix) {lib * 1e3:.2f} us, bound {b[0] * 1e3:.2f} us ({b[1]})")

    slots = -(-(ENGINE_CTX + ENGINE_GEN + 1) // 8) * 8  # the engine's cache (Engine rounds to 8)
    for label, h, kvh in (("heads 32/32", hq, hkv), ("GQA heads 32/8", 32, 8)):
        pos = torch.linspace(ENGINE_CTX, ENGINE_CTX + ENGINE_GEN - 1, ENGINE_SLOTS,
                             device="cuda").long()
        q = randn(ENGINE_SLOTS, 1, h, dh)
        kc, vc = randn(ENGINE_SLOTS, kvh, slots, dh), randn(ENGINE_SLOTS, kvh, slots, dh)
        past = torch.arange(slots, device="cuda") > pos[:, None]  # [B, slots]
        kc[past[:, None, :, None].expand_as(kc)] = 1e4  # a read past the row's frontier shows
        vc[past[:, None, :, None].expand_as(vc)] = 1e4
        err = check(f"K3 W=1 B={ENGINE_SLOTS} {label} positions {pos.tolist()}",
                    flash.flash_window_attention(q, kc, vc, pos),
                    flash.flash_window_attention_plain(f32(q), f32(kc), f32(vc), pos))
        keep_err(k3, err)
        if kvh != hkv:
            continue
        ms = time_ms(lambda i: flash.flash_window_attention(q, kc, vc, pos))
        plain = time_ms(lambda i: flash.flash_window_attention_plain(q, kc, vc, pos))
        qh = q.transpose(1, 2)
        kh, vh = (t.repeat_interleave(h // kvh, 1) for t in (kc, vc))
        mask = ~past[:, None, None, :]
        lib = time_ms(lambda i: sdpa(qh, kh, vh, attn_mask=mask))
        n_keys = int((pos + 1).sum())
        nbytes = 2 * (2 * ENGINE_SLOTS * h * dh) + 2 * kvh * n_keys * dh * 2
        b = bound_ms(nbytes, 4 * h * dh * n_keys)
        k3.d.update(w1_ms=ms, w1_plain_ms=plain, w1_library_ms=lib, w1_bound_ms=b[0])
        log(f"    W=1, B={ENGINE_SLOTS}, {slots} slots: kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.1f} us, SDPA (boolean mask) {lib * 1e3:.2f} us, bound "
            f"{b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")

    for s_full, label, h, kvh in ((s, *c) for s in FULL_WINDOWS
                                  for c in (("heads 32/32", hq, hkv), ("GQA heads 32/8", 32, 8))):
        q = randn(1, s_full, h, dh)
        kc, vc = randn(1, kvh, s_full, dh), randn(1, kvh, s_full, dh)
        err = check(f"K3 S={s_full} full window, no cache, {label}",
                    flash.flash_window_attention(q, kc, vc, 0),
                    flash.flash_window_attention_plain(f32(q), f32(kc), f32(vc), 0))
        keep_err(k3, err)
        if kvh != hkv:
            continue
        ms = time_ms(lambda i: flash.flash_window_attention(q, kc, vc, 0))
        plain = time_ms(lambda i: flash.flash_window_attention_plain(q, kc, vc, 0),
                        inner=2, reps=3)
        qh = q.transpose(1, 2)
        kh, vh = (t.repeat_interleave(h // kvh, 1) for t in (kc, vc))
        lib = time_ms(lambda i: sdpa(qh, kh, vh, is_causal=True))
        nbytes = 2 * (2 * s_full * h * dh + 2 * kvh * s_full * dh)
        b = bound_ms(nbytes, 4 * h * dh * s_full * (s_full + 1) // 2)
        k3.d.update({f"s{s_full}_ms": ms, f"s{s_full}_plain_ms": plain,
                     f"s{s_full}_library_ms": lib, f"s{s_full}_bound_ms": b[0]})
        log(f"    S={s_full}: kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.1f} us, SDPA "
            f"(causal) {lib * 1e3:.2f} us, bound {b[0] * 1e3:.2f} us ({b[1]})")
    k3.d["per"] = (f"one prefill layer, S={PROMPT}, {CACHE} slots (w1_*: the engine's W=1 windows, "
                   f"B={ENGINE_SLOTS}, {slots} slots; s512_*, s2048_*, s4096_*: a window without "
                   "a cache, as eval_ppl and the quantization's calibration forwards run it)")

    # ---- K4
    log("[attention] K4 decode_attention vs plain")
    for slots, h, kvh in ((CACHE, hq, hkv), (4096, hq, hkv), (CACHE, 32, 8)):
        q = randn(1, h, dh)
        kc, vc = randn(1, kvh, slots, dh), randn(1, kvh, slots, dh)
        for pos in sorted({0, 255, 256, slots // 2, main_pos if slots == CACHE else slots - 1}):
            keep_err(k4, check(f"K4 {slots} slots heads {h}/{kvh} pos {pos}",
                               attention.decode_attention(q, kc, vc, pos),
                               attention.decode_attention_plain(f32(q), f32(kc), f32(vc), pos)))
        if slots != 4096:
            continue
        pos = slots - 1
        ms = time_ms(lambda i: attention.decode_attention(q, kc, vc, pos))
        plain = time_ms(lambda i: attention.decode_attention_plain(q, kc, vc, pos))
        kh, vh = (t[:, :, : pos + 1].repeat_interleave(rep, 1) for t in (kc, vc))
        lib = time_ms(lambda i: sdpa(q[:, :, None], kh, vh))
        nbytes = 2 * (2 * h * dh) + 2 * kvh * (pos + 1) * dh * 2
        b = bound_ms(nbytes, 4 * h * (pos + 1) * dh)
        k4.d.update(ms_4096=ms, plain_ms_4096=plain, library_ms_4096=lib, bound_ms_4096=b[0])
        log(f"    4096 slots pos {pos} (one cache): kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.1f} us, SDPA over the valid prefix {lib * 1e3:.2f} us, "
            f"bound {b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
        del kh, vh
    pos = main_pos
    q = randn(1, hq, dh)
    kc, vc = randn(n_layers, 1, hkv, CACHE, dh), randn(n_layers, 1, hkv, CACHE, dh)
    plain = time_ms(lambda i: attention.decode_attention_plain(q, kc[0], vc[0], pos))
    lib_in = [(q[:, :, None], *(t[l, :, :, : pos + 1].repeat_interleave(rep, 1) for t in (kc, vc)))
              for l in range(n_layers)]
    ms, lib, hot, hot_lib = _hot_and_rotating(
        lambda l: attention.decode_attention(q, kc[l], vc[l], pos), lib_in, sdpa, n_layers)
    k4.d.update(hot_ms=hot, hot_library_ms=hot_lib)
    nbytes = 2 * (2 * hq * dh + 2 * hkv * (pos + 1) * dh)
    b = k4.add(0.0, ms, plain, lib, nbytes, 4 * hq * (pos + 1) * dh, bw)
    log(f"    pos {pos}, {CACHE} slots, rotating over {n_layers} layers: kernel {ms * 1e3:.2f} us, "
        f"SDPA over the valid prefix {lib * 1e3:.2f} us; hot (one layer): kernel "
        f"{hot * 1e3:.2f} us, SDPA {hot_lib * 1e3:.2f} us; plain {plain * 1e3:.1f} us, bound "
        f"{b[0] * 1e3:.2f} us ({b[1]})")
    per_call = {"decode_attention": _kernels_a_call(
        lambda i: attention.decode_attention(q, kc[i % n_layers], vc[i % n_layers], pos))}
    del kc, vc, lib_in
    k4.d["per"] = (f"one decode layer at pos {main_pos}, {CACHE} slots, rotating over {n_layers} "
                   "layers (hot_*: one layer; *_4096: pos 4095 of 4096, one cache)")

    # ---- K4's grouped-head path (H / Hkv >= 16): Falcon-7b's batch of 8
    log(f"[attention] K4 group path vs plain: Falcon-7b's {GROUP_B} x {GROUP_HEADS}/1 heads of 64 "
        f"over {GROUP_SLOTS} slots; Falcon-40b's 128/8")
    from qeft_tpu_torch.models.common import attention as family_attention
    from qeft_tpu_torch.models.common import causal_bias

    for b, h, kvh in ((GROUP_B, GROUP_HEADS, 1), (GROUP_B, 128, 8)):
        q = randn(b, h, 64)
        kc, vc = randn(b, kvh, GROUP_SLOTS, 64), randn(b, kvh, GROUP_SLOTS, 64)
        for pos in (0, 15, 16, *GROUP_POSITIONS):
            keep_err(k4, check(f"K4 group B={b} heads {h}/{kvh} pos {pos}",
                               attention.decode_attention(q, kc, vc, pos),
                               attention.decode_attention_plain(f32(q), f32(kc), f32(vc), pos)))
        del kc, vc
    q = randn(GROUP_B, GROUP_HEADS, 64)
    kc, vc = randn(n_layers, GROUP_B, 1, GROUP_SLOTS, 64), randn(n_layers, GROUP_B, 1, GROUP_SLOTS, 64)
    for pos in GROUP_POSITIONS:
        ms = time_ms(lambda i: attention.decode_attention(q, kc[i % n_layers], vc[i % n_layers], pos))
        mask = causal_bias(torch.tensor([pos], device="cuda"), GROUP_SLOTS)
        glue = time_ms(lambda i: family_attention(q[:, None], kc[i % n_layers], vc[i % n_layers],
                                                  mask))
        nbytes = 2 * (2 * GROUP_B * GROUP_HEADS * 64) + 2 * GROUP_B * (pos + 1) * 64 * 2
        b = bound_ms(nbytes, 4 * GROUP_B * GROUP_HEADS * (pos + 1) * 64)
        k4.d.update({f"group_ms_{pos}": ms, f"group_glue_ms_{pos}": glue,
                     f"group_bound_ms_{pos}": b[0]})
        log(f"    pos {pos}, rotating over {n_layers} layers: kernel {ms * 1e3:.2f} us, the "
            f"families' plain attention over the whole cache {glue * 1e3:.1f} us, bound "
            f"{b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
    per_call["decode_attention group"] = _kernels_a_call(
        lambda i: attention.decode_attention(q, kc[i % n_layers], vc[i % n_layers],
                                             GROUP_POSITIONS[1]))
    del kc, vc
    k4.d["per"] += (f"; group_*: Falcon-7b's B = {GROUP_B}, {GROUP_HEADS}/1 heads over "
                    f"{GROUP_SLOTS} slots at pos {GROUP_POSITIONS}, rotating over {n_layers} layers, "
                    "group_glue_*: the families' plain attention it replaces")

    # ---- K4q
    log("[attention] K4q decode_attention_int8 vs plain (int8 codes, f32 scales)")
    for slots, h, kvh in ((CACHE, hq, hkv), (4096, hq, hkv), (CACHE, 32, 8), (4096, 32, 8)):
        q = randn(1, h, dh)
        (kc, ks), (vc, vs) = int8_cache(1, kvh, slots, dh), int8_cache(1, kvh, slots, dh)
        for pos in sorted({0, 255, 256, slots // 2, main_pos if slots == CACHE else slots - 1}):
            keep_err(k4q, check(f"K4q {slots} slots heads {h}/{kvh} pos {pos}",
                                attention.decode_attention(q, kc, vc, pos, k_scale=ks, v_scale=vs),
                                attention.decode_attention_plain(f32(q), kc, vc, pos, ks, vs)))
        if slots != 4096 or kvh != hkv:
            continue
        pos = slots - 1
        ms = time_ms(lambda i: attention.decode_attention(q, kc, vc, pos, k_scale=ks, v_scale=vs))
        plain = time_ms(lambda i: attention.decode_attention_plain(q, kc, vc, pos, ks, vs))
        kh, vh = (_dequant(c[:, :, : pos + 1], s[:, :, : pos + 1]).repeat_interleave(rep, 1)
                  for c, s in ((kc, ks), (vc, vs)))
        lib = time_ms(lambda i: sdpa(q[:, :, None], kh, vh))
        nbytes = 2 * (2 * h * dh) + 2 * kvh * (pos + 1) * (dh + 4)
        b = bound_ms(nbytes, 4 * h * (pos + 1) * dh)
        k4q.d.update(ms_4096=ms, plain_ms_4096=plain, library_ms_4096=lib, bound_ms_4096=b[0])
        log(f"    4096 slots pos {pos} (one cache): kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.1f} us, SDPA over the dequantized valid prefix {lib * 1e3:.2f} us, "
            f"bound {b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
        del kh, vh
    pos = main_pos
    q = randn(1, hq, dh)
    (kc, ks), (vc, vs) = (int8_cache(n_layers, 1, hkv, CACHE, dh) for _ in range(2))
    plain = time_ms(lambda i: attention.decode_attention_plain(q, kc[0], vc[0], pos, ks[0], vs[0]))
    lib_in = [(q[:, :, None], *(_dequant(c[l, :, :, : pos + 1], s[l, :, :, : pos + 1])
                                .repeat_interleave(rep, 1) for c, s in ((kc, ks), (vc, vs))))
              for l in range(n_layers)]
    ms, lib, hot, hot_lib = _hot_and_rotating(
        lambda l: attention.decode_attention(q, kc[l], vc[l], pos, k_scale=ks[l], v_scale=vs[l]),
        lib_in, sdpa, n_layers)
    k4q.d.update(hot_ms=hot, hot_library_ms=hot_lib)
    nbytes = 2 * (2 * hq * dh) + 2 * hkv * (pos + 1) * (dh + 4)
    b = k4q.add(0.0, ms, plain, lib, nbytes, 4 * hq * (pos + 1) * dh, bw)
    log(f"    pos {pos}, {CACHE} slots, rotating over {n_layers} layers: kernel {ms * 1e3:.2f} us, "
        f"SDPA over the dequantized valid prefix {lib * 1e3:.2f} us; hot (one layer): kernel "
        f"{hot * 1e3:.2f} us, SDPA {hot_lib * 1e3:.2f} us; plain {plain * 1e3:.1f} us, bound "
        f"{b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
    per_call["decode_attention_int8"] = _kernels_a_call(
        lambda i: attention.decode_attention(q, kc[i % n_layers], vc[i % n_layers], pos,
                                             k_scale=ks[i % n_layers], v_scale=vs[i % n_layers]))
    del kc, vc, ks, vs, lib_in
    k4q.d["per"] = (f"one decode layer at pos {main_pos}, {CACHE} slots, rotating over {n_layers} "
                    "layers (hot_*: one layer; *_4096: pos 4095 of 4096, one cache)")

    # ---- K8
    log(f"[attention] K8 decode_attention_stacked vs plain, the stacked {n_layers}-layer cache "
        f"of {CACHE} slots, slots >= pos poisoned")
    for quantized in (False, True):
        shape = (n_layers, 1, hkv, CACHE, dh)
        q, kn, vn = randn(1, hq, dh), randn(1, hkv, dh), randn(1, hkv, dh)
        if quantized:
            (kc, ks), (vc, vs) = int8_cache(*shape), int8_cache(*shape)
            scales = dict(k_scale=ks, v_scale=vs)
        else:
            kc, vc = randn(*shape), randn(*shape)
            scales = {}
        label = "int8" if quantized else "bf16"
        for pos in (0, 1, 256, main_pos):
            kp, vp = kc.clone(), vc.clone()
            sp = {k: v.clone() for k, v in scales.items()}
            poison = 127 if quantized else 1e4
            kp[:, :, :, pos:] = poison
            vp[:, :, :, pos:] = poison
            for v in sp.values():
                v[:, :, :, pos:] = 1e3
            for layer in (0, n_layers - 1):
                want = attention.decode_attention_stacked_plain(
                    f32(q), kp if quantized else f32(kp), vp if quantized else f32(vp), layer,
                    pos, f32(kn), f32(vn), **sp)
                keep_err(k8, check(
                    f"K8 {label} layer {layer} pos {pos}",
                    attention.decode_attention_stacked(q, kp, vp, layer, pos, kn, vn, **sp), want))
            del kp, vp, sp
        pos = main_pos
        plain = time_ms(lambda i: attention.decode_attention_stacked_plain(
            q, kc, vc, i % n_layers, pos, kn, vn, **scales))
        lib_in = []
        for l in range(n_layers):
            if quantized:
                kh, vh = (_dequant(c[l, :, :, :pos], s[l, :, :, :pos]) for c, s in ((kc, ks), (vc, vs)))
            else:
                kh, vh = kc[l, :, :, :pos], vc[l, :, :, :pos]
            lib_in.append((q[:, :, None], *(torch.cat([t, t_new[:, :, None]], 2)
                                            .repeat_interleave(rep, 1)
                                            for t, t_new in ((kh, kn), (vh, vn)))))
        ms, lib, hot, hot_lib = _hot_and_rotating(
            lambda l: attention.decode_attention_stacked(q, kc, vc, l, pos, kn, vn, **scales),
            lib_in, sdpa, n_layers)
        per_slot = dh + 4 if quantized else 2 * dh
        nbytes = 2 * (2 * hq * dh) + 2 * hkv * pos * per_slot + 2 * (2 * hkv * dh)
        flops = 4 * hq * (pos + 1) * dh
        if quantized:
            b = bound_ms(nbytes, flops)
            k8.d.update(int8_ms=ms, int8_plain_ms=plain, int8_library_ms=lib, int8_bound_ms=b[0],
                        int8_hot_ms=hot, int8_hot_library_ms=hot_lib)
        else:
            b = k8.add(0.0, ms, plain, lib, nbytes, flops, bw)
            k8.d.update(hot_ms=hot, hot_library_ms=hot_lib)
        log(f"    {label}, pos {pos}, rotating over {n_layers} layers: kernel {ms * 1e3:.2f} us, "
            f"SDPA over the dequantized prefix and the new token {lib * 1e3:.2f} us; hot (layer 0): "
            f"kernel {hot * 1e3:.2f} us, SDPA {hot_lib * 1e3:.2f} us; plain {plain * 1e3:.1f} us, "
            f"bound {b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
        per_call[f"decode_attention_stacked {label}"] = _kernels_a_call(
            lambda i: attention.decode_attention_stacked(q, kc, vc, i % n_layers, pos, kn, vn,
                                                         **scales))
        del kc, vc, scales, lib_in
    k8.d["per"] = (f"one decode layer at pos {main_pos}, {CACHE} slots, bf16 cache, rotating over "
                   f"{n_layers} layers (hot_*: layer 0 only; int8_*: the int8 cache)")
    per_call["decode_latent_attention"] = _latent_rows(bw, rows)
    log(f"[attention] the CUDA kernels of a call in the profiler (names, records a call): "
        f"{per_call}")
    return per_call


def _latent_rows(bw, rows):
    """The latent decode attention (`decode_latent_attention`) against its
    plain version in f32 at the deepseek-v2-lite.batch64 cell's shape: B =
    DS_BATCH sequences of 16 heads over DS_SLOTS rows of 576 (values the
    first 512), at positions where the splits' chunks are empty or ragged
    and up to the cache's end; timed at DS_POSITIONS rotating over the
    model's 27 layers beside its bound (B x (pos + 1) x 1152 B of rows, q
    and the output).  Returns its CUDA kernels a call in the profiler."""
    from qeft_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_PRESETS
    from qeft_tpu_torch.ops import attention

    cfg = DEEPSEEK_V2_PRESETS["deepseek-v2-lite"]
    h, d, dv, n_layers = cfg.num_heads, cfg.latent_dim, cfg.kv_lora_rank, cfg.num_layers
    scale = cfg.softmax_scale
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    row = rows["decode_latent_attention"] = Row(
        "decode_latent_attention", "qeft_tpu_torch/csrc/decode_attention.cu",
        "none (qeft_tpu has no latent attention)", False)
    log(f"[attention] latent decode attention vs plain: B={DS_BATCH}, {h} heads over "
        f"{DS_SLOTS} rows of {d} (values the first {dv}), rotating over {n_layers} layers")
    q = randn(DS_BATCH, h, d)
    c = randn(n_layers, DS_BATCH, DS_SLOTS, d)
    for pos in (0, 1, 15, 16, 31, 32, 255, *DS_POSITIONS):
        err = check(f"latent B={DS_BATCH} pos {pos}",
                    attention.decode_latent_attention(q, c[0], pos, scale),
                    attention.decode_latent_attention_plain(f32(q), f32(c[0]), pos, scale))
        row.d["max_abs_err"] = max(row.d["max_abs_err"], err)
    for pos in DS_POSITIONS:
        ms = time_ms(lambda i: attention.decode_latent_attention(q, c[i % n_layers], pos, scale))
        plain = time_ms(lambda i: attention.decode_latent_attention_plain(
            q, c[i % n_layers], pos, scale), inner=2, reps=3)
        nbytes = DS_BATCH * (pos + 1) * d * 2 + 2 * DS_BATCH * h * (d + dv)
        flops = 2 * DS_BATCH * h * (pos + 1) * (d + dv)
        if pos == DS_POSITIONS[-1]:
            b = row.add(0.0, ms, plain, None, nbytes, flops, bw)
        else:
            b = bound_ms(nbytes, flops)
        row.d.update({f"ms_{pos}": ms, f"plain_ms_{pos}": plain, f"bound_ms_{pos}": b[0]})
        log(f"    pos {pos}: kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.1f} us, bound "
            f"{b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B), {b[0] / ms * 100:.1f} % of it")
    per_call = _kernels_a_call(
        lambda i: attention.decode_latent_attention(q, c[i % n_layers], DS_POSITIONS[1], scale))
    row.d["per"] = (f"one decode layer of deepseek-v2-lite.batch64 at pos {DS_POSITIONS[-1]}, "
                    f"B={DS_BATCH}, {DS_SLOTS} slots, rotating over {n_layers} layers (ms_<pos>: "
                    "the other positions)")
    del c
    torch.cuda.empty_cache()
    return per_call


def _moe_matvec_rows(bw, rows):
    """The grouped expert matvec (`qgemv_moe`) against its plain version in
    f32 at one expert layer of the deepseek-v2-lite.batch64 cell's decode:
    DS_BATCH tokens routed top-6 over 64 experts by ``moe.route`` (a random
    router) and sorted by ``moe.dispatch``, through the experts' gate/up
    (2048 -> 2816) and down (1408 -> 2048), random w4/g128/r128 weights of
    fan-in scale; timed beside its bound (the touched experts' codes, scales
    and slab once, the rows in and out)."""
    from qeft_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_PRESETS
    from qeft_tpu_torch.ops import moe, qmm
    from qeft_tpu_torch.testing import random_packed_linear

    cfg = DEEPSEEK_V2_PRESETS["deepseek-v2-lite"]
    e, top_k, d, f = (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.hidden_size,
                      cfg.moe_intermediate_size)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    x = torch.randn(DS_BATCH, d, generator=gen, device="cuda").to(torch.bfloat16)
    router = (torch.randn(d, e, generator=gen, device="cuda") * d ** -0.5).to(torch.bfloat16)
    _, chosen = moe.route(x, router, top_k)
    counts, offsets, _ = moe.dispatch(chosen, e)
    touched, most = int((counts > 0).sum()), int(counts.max())
    n_rows = DS_BATCH * top_k
    row = rows["qgemv_moe"] = Row("qgemv_moe", "qeft_tpu_torch/csrc/qmm.cu",
                                  "none (qeft_tpu has no expert layer)", False)
    log(f"[matvec] grouped expert matvec vs plain: {DS_BATCH} tokens top-{top_k} over {e} "
        f"experts ({touched} touched, at most {most} rows on one)")
    for name, k, n in (("gate_up", d, 2 * f), ("down", f, d)):
        p = random_packed_linear(gen, e, k, n, 128, 128, fan_in=True)
        xs = torch.randn(n_rows, k, generator=gen, device="cuda").to(torch.bfloat16)
        got = qmm.qgemv_moe(xs, p, counts, offsets, DS_BATCH)
        if not torch.equal(qmm.qgemv_moe(xs, p, counts, offsets, DS_BATCH), got):
            raise AssertionError(f"qgemv_moe {name}: two calls on the same inputs differ")
        err = check(f"qgemv_moe {name} {k}->{n}", got,
                    qmm.qgemv_moe_plain(f32(xs), f32(p), counts, offsets))
        OUTPUTS[f"qgemv_moe {name}"] = (_splits(-(-n // 256) * e, k // 128), got.cpu())
        ms = time_ms(lambda i: qmm.qgemv_moe(xs, p, counts, offsets, DS_BATCH))
        plain = time_ms(lambda i: qmm.qgemv_moe_plain(xs, p, counts, offsets), inner=2, reps=3)
        nbytes = touched * (k * n // 2 + 2 * 2 * (k // 128) * n + 2 * 128 * n) + 2 * n_rows * (k + n)
        b = row.add(err, ms, plain, None, nbytes, 2 * n_rows * k * n, bw)
        row.d.update({f"{name}_ms": ms, f"{name}_bound_ms": b[0]})
        log(f"    {name}: kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.1f} us, bound "
            f"{b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B), {b[0] / ms * 100:.1f} % of it")
        del p, xs
    row.d.update(touched=touched, max_rows=most)
    row.d["per"] = (f"one expert layer of deepseek-v2-lite.batch64 at decode: gate_up + down over "
                    f"{DS_BATCH} x {top_k} rows ({touched} experts touched)")
    torch.cuda.empty_cache()


def phase_deepseek(bw, rows, kernels=False):
    """DeepSeek-V2-Lite's main path: the grouped expert matvec's rows
    (`_moe_matvec_rows`; ``kernels``: the latent kernel's too, which the
    attention phase times otherwise), then a random packed model at full
    size (27 layers, 64 + 2 experts a layer, w4/g128/r128) built on the
    card and ``generate`` -- DS_BATCH prompts of DS_PROMPT tokens, DS_NEW
    greedy, the cell's DS_SLOTS-slot latent cache, the decode loop as
    replays of one captured step -- with its prefill counted alone first
    and the decode steps' launches checked: per step qgemv_moe twice an
    expert layer, decode_latent_attention once a layer, K2 for every dense
    linear at M = DS_BATCH, nothing else; tokens equal to the eager
    loop's."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_PRESETS
    from qeft_tpu_torch.testing import build_packed_model

    if kernels:
        per_call = _latent_rows(bw, rows)
        if len(per_call[0]) != 1 or not 0 < per_call[1] <= 1:
            raise AssertionError(f"the latent kernel must be one kernel a call: {per_call}")
    _moe_matvec_rows(bw, rows)
    cfg = DEEPSEEK_V2_PRESETS["deepseek-v2-lite"]
    tick = time.perf_counter()
    params = build_packed_model(cfg, seed=0, g=128, r=128, device="cuda", family="deepseek_v2")
    torch.cuda.synchronize()
    log(f"[deepseek] random packed deepseek-v2-lite (27 layers, 64 + 2 experts a layer, "
        f"w4/g128/r128) built in {time.perf_counter() - tick:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    api = get_model_api("deepseek_v2")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (DS_BATCH, DS_PROMPT), generator=gen, device="cuda")

    def new_cache():
        return api.init_cache(cfg, DS_BATCH, DS_SLOTS, device="cuda")

    generate(params, prompt, new_cache(), cfg, 8, api=api, device="cuda")  # warm-up
    with counted("deepseek prefill") as pre:
        api.prefill(params, prompt, new_cache(), cfg)
    with counted("deepseek generate") as c:
        tick = time.perf_counter()
        tokens, _ = generate(params, prompt, new_cache(), cfg, DS_NEW, api=api, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    steps = DS_NEW - 1
    # the prefill's (K2, and K5 for an expert of 8 rows or fewer), then per
    # step: q, kv_a and o and the dense MLP's or the shared experts' gate/up
    # and down of each layer (K2 above 8 rows, else K5), the experts' two
    # grouped matvecs and the latent attention
    want = dict(pre.counts)
    dense = "qgemm" if DS_BATCH > 8 else "qgemv"
    want[dense] = want.get(dense, 0) + 5 * cfg.num_layers * steps
    want.update(qgemv_moe=2 * cfg.moe_layers * steps,
                decode_latent_attention=cfg.num_layers * steps)
    log(f"[deepseek generate] {DS_BATCH} x ({DS_PROMPT} + {DS_NEW} greedy) in {dt:.3f} s "
        f"({DS_BATCH * DS_NEW / dt:.1f} tokens/s, host clock, decode loop as CUDA graph "
        f"replays); prefill alone launched {pre.counts}; generate {c.counts}; expected {want}")
    if c.counts != want or pre.counts.get("qgemv_moe") or pre.counts.get("decode_latent_attention"):
        raise AssertionError("deepseek generate: did not launch each kernel as expected")
    eager, _ = generate(params, prompt, new_cache(), cfg, DS_NEW, api=api, device="cuda",
                        graph=False)
    if not torch.equal(eager, tokens):
        raise AssertionError("deepseek generate: the graph loop's tokens differ from the eager "
                             "loop's")
    log(f"[deepseek generate] graph tokens equal to the eager loop's ({tokens.numel()} tokens); "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return dict(tok_s=DS_BATCH * DS_NEW / dt)


def _one_layer(p, l):
    """A stacked view holding layer ``l`` only (for the dense yardstick)."""
    return p.map(lambda t: t[l: l + 1])


def phase_main(cfg, params, nbytes):
    from qeft_tpu_torch import main as cli
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api("llama")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device="cuda")

    def new_cache():
        return api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")

    generate(params, prompt, new_cache(), cfg, 8, api=api, device="cuda")  # warm-up
    torch.cuda.synchronize()
    tick = time.perf_counter()
    _, cache = api.prefill(params, prompt, new_cache(), cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - tick) * 1e3

    cache = new_cache()
    with counted("generate") as c:
        tick = time.perf_counter()
        tokens, _ = generate(params, prompt, cache, cfg, NEW_TOKENS, api=api, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    counts = c.counts
    steps = NEW_TOKENS - 1
    want = {"qgemv_stacked_fused": 4 * cfg.num_layers * steps, "decode_attention": cfg.num_layers * steps,
            "qgemm": 4 * cfg.num_layers, "flash_window_attention": cfg.num_layers}
    log(f"[main] generate: prefill {PROMPT} + {NEW_TOKENS} greedy tokens in {dt:.3f} s -> "
        f"{NEW_TOKENS / dt:.2f} tok/s, {dt / NEW_TOKENS * 1e3:.3f} ms/token (host clock, "
        f"decode loop as CUDA graph replays); prefill alone {prefill_ms:.2f} ms")
    kv_per_pos = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    mean_pos = PROMPT + steps / 2
    per_token = nbytes + kv_per_pos * mean_pos
    log(f"[main] bytes/token: {nbytes} weights + {kv_per_pos} x {mean_pos:.1f} mean cached "
        f"positions = {per_token:.0f} -> {per_token / (dt / NEW_TOKENS) / 1e9:.1f} GB/s achieved")
    log(f"[main] launches {counts}; expected {want}")
    if counts != want:
        raise AssertionError("the main path did not launch each kernel as expected")
    if tokens.shape != (1, NEW_TOKENS) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    bench = cli.benchmark(params, cfg, api, NEW_TOKENS, torch.device("cuda"), "synthetic", 0)
    return prompt, tokens, dict(tok_s=NEW_TOKENS / dt, ms_token=dt / NEW_TOKENS * 1e3,
                                prefill_ms=prefill_ms, seconds=dt, **bench)


@torch.inference_mode()
def phase_profile(cfg, params, prompt, family="llama", tag="profile"):
    """Where the device time of a decode step and of the prefill goes
    (torch.profiler, CUDA activity), and the device's idle share: summed
    kernel time over host-clock time of the same work run unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api(family)
    steps = 16
    tok = prompt[:, :1]

    def prefill():
        return api.prefill(params, prompt, api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16,
                                                          device="cuda"), cfg)[1]

    def decode(cache):
        for i in range(steps):
            api.decode_step(params, tok, cache, PROMPT + i, cfg)

    out = {}
    for label, work, per in (("prefill", lambda c: prefill(), 1),
                             ("eager decode step", decode, steps)):
        cache = prefill()
        torch.cuda.synchronize()
        tick = time.perf_counter()
        work(cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tick) * 1e3 / per
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            work(cache)
            torch.cuda.synchronize()
        kernels, busy = kernel_times(prof, per)
        if busy == 0:
            log(f"[{tag}] {label}: wall {wall_ms:.3f} ms; device time not measured "
                "(the profiler recorded no CUDA kernel)")
            continue
        log(f"[{tag}] {label}: wall {wall_ms:.3f} ms (host clock, unprofiled), device busy "
            f"{busy:.3f} ms -> idle share {max(0.0, 1 - busy / wall_ms):.1%}; top kernels:")
        for name, ms in kernels[:8]:
            log(f"    {ms * 1e3:9.1f} us  {ms / busy:6.1%}  {name[:90]}")
        out[label] = dict(wall_ms=wall_ms, busy_ms=busy)
    return out


@torch.inference_mode()
def _teacher_forced(params, cfg, api, prompt, tokens, quantized=False):
    """Logits that predicted each generated token: prefill, then one decode
    step per generated token but the last."""
    cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda",
                           quantized=quantized)
    logits, cache = api.prefill(params, prompt, cache, cfg)
    out = [logits[:, -1].float()]
    for i in range(tokens.shape[1] - 1):
        logits, cache = api.decode_step(params, tokens[:, i: i + 1], cache, PROMPT + i, cfg)
        out.append(logits.float())
    return torch.cat(out)  # [generated tokens, V]


def phase_oracle(cfg, params, prompt, tokens):
    """Bound ORACLE_RTOL of the dense logits' scale per step: both paths are
    bf16 through 32 random-weight layers whose attention is near one-hot, so a
    near tie can swing a head; a kernel that is wrong moves every logit by
    the logit scale itself."""
    from qeft_tpu_torch.data import get_loaders
    from qeft_tpu_torch.eval import eval_ppl
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.testing import dense_model

    api = get_model_api("llama")
    tick = time.perf_counter()
    dense = dense_model(params)
    torch.cuda.synchronize()
    log(f"[oracle] dense bf16 model (plain PyTorch path) built in {time.perf_counter() - tick:.1f} s")
    lk = _teacher_forced(params, cfg, api, prompt, tokens)
    ld = _teacher_forced(dense, cfg, api, prompt, tokens)
    diff = (lk - ld).abs().amax(dim=-1)
    scale = ld.abs().amax().item()
    log(f"[oracle] teacher-forced max |logit diff| per step: "
        + " ".join(f"{v:.3g}" for v in diff.tolist()))
    worst = diff.max().item()
    log(f"[oracle] max {worst:.4g}, median {diff.median().item():.4g}, dense logit scale "
        f"{scale:.4g}, bound {ORACLE_RTOL * scale:.4g}; argmax agreement "
        f"{(lk.argmax(-1) == ld.argmax(-1)).sum().item()}/{NEW_TOKENS}")
    if not (torch.isfinite(lk).all() and worst <= ORACLE_RTOL * scale):
        raise AssertionError("kernel path disagrees with the dense model")
    test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
    ppl_k = eval_ppl(params, test, cfg, seqlen=512, max_windows=2, api=api, device="cuda")
    ppl_d = eval_ppl(dense, test, cfg, seqlen=512, max_windows=2, api=api, device="cuda")
    delta = abs(ppl_k - ppl_d) / ppl_d
    log(f"[oracle] synthetic ppl (2 windows of 512): kernel path {ppl_k:.4f}, dense "
        f"{ppl_d:.4f}, relative delta {delta:.4%}")
    if not (ppl_k == ppl_k and ppl_d == ppl_d):
        raise AssertionError("PPL is not finite")
    dense_tokens, _ = generate(dense, prompt, api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16,
                                                             device="cuda"),
                               cfg, NEW_TOKENS, api=api, device="cuda")
    same = (dense_tokens == tokens)[0]
    prefix = int(same.long().cumprod(0).sum().item())
    log(f"[oracle] greedy tokens equal to the dense model's: {int(same.sum())}/{NEW_TOKENS} "
        f"(common prefix {prefix}); printed, not required")
    return dict(max_logit_diff=worst, logit_scale=scale, ppl_kernel=ppl_k, ppl_dense=ppl_d)


def _sft_batches(cfg, seed: int = 42):
    """run_finetune's data: synthetic SFT examples, batches of 4 x 512."""
    from qeft_tpu_torch.data.sft import batches, synthetic_sft_examples

    examples = synthetic_sft_examples(256, cfg.vocab_size, seed)
    for b in batches(examples, TRAIN_BATCH, TRAIN_SEQ, seed, epochs=100):
        yield (torch.as_tensor(b["input_ids"], device="cuda"),
               torch.as_tensor(b["labels"], device="cuda"))


def phase_train_kernels(cfg, params, bw, rows):
    """K7 and K2 at the training shapes, M = 4 x 512 token rows: the four
    Llama stages (the layer rotating over 32), then the family shapes
    (FAMILY_SHAPES, a random 2-layer stack each), kept under the K2 and K7
    rows as ``family_m2048``."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.ops.qlinear import matmul_f32
    from qeft_tpu_torch.testing import dense_linear, random_packed_linear

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    m = TRAIN_BATCH * TRAIN_SEQ
    layers, n_layers = params["layers"], cfg.num_layers
    k7 = rows["qgemm_t"] = Row("qgemm_t", "qeft_tpu_torch/csrc/qmm.cu",
                               "qeft_tpu/ops/pallas_qmm.py:691", True)
    k2 = Row("qgemm", "", "", True)  # K2 at the training shape, merged into its row below
    shapes = [(name, lambda name=name: (layers[name], n_layers), False)
              for name in ("qkv", "o", "upgate", "down")]
    shapes += [(label, lambda k=k, n=n, g=g: (random_packed_linear(gen, 2, k, n, g, 128,
                                                                   fan_in=True), 2), True)
               for label, k, n, g in FAMILY_SHAPES]
    log(f"[train-kernels] K7 qgemm_t and K2 qgemm vs plain, M={m}: the Llama stages (layer "
        f"rotating over {n_layers}), then the family shapes (over 2)")
    for label, make, is_family in shapes:
        p, nl = make()
        k, n, r = p.in_features, p.out_features, p.n_outlier
        gy = randn(m, n)
        tail = matmul_f32(gy, p.oweight[1].t())  # the weak-column product of the backward
        err7 = check(f"K7 {label} {n}->{k}", qmm.qgemm_t(gy, p.layer(1), tail),
                     qmm.qgemm_t_plain(f32(gy), f32(p.layer(1)), tail))
        ms7 = time_ms(lambda i: qmm.qgemm_t(gy, p.layer(i % nl), tail))
        plain7 = time_ms(lambda i: qmm.qgemm_t_plain(gy, p.layer(i % nl), tail),
                         inner=2, reps=3)
        w = dense_linear(_one_layer(p, 0))[0]
        lib7 = time_ms(lambda i: torch.matmul(gy, w.t()))
        wbytes = k * n // 2 + 4 * (k // p.group_size) * n
        x = randn(m, k)
        err2 = check(f"K2 {label} {k}->{n}", qmm.qgemm(x, p.layer(1)),
                     qmm.qgemm_plain(f32(x), f32(p.layer(1))))
        ms2 = time_ms(lambda i: qmm.qgemm(x, p.layer(i % nl)))
        plain2 = time_ms(lambda i: qmm.qgemm_plain(x, p.layer(i % nl)), inner=2, reps=3)
        lib2 = time_ms(lambda i: torch.matmul(x, w))
        del w
        for name, row, err, ms, plain, lib, nbytes, flops in (
                ("K7", k7, err7, ms7, plain7, lib7, wbytes + 2 * m * (n + k) + 4 * m * r,
                 2 * m * k * n),
                ("K2", k2, err2, ms2, plain2, lib2, wbytes + 2 * r * n + 2 * m * (k + n),
                 2 * m * (k + r) * n)):
            if not is_family:
                b = row.add(err, ms, plain, lib, nbytes, flops, bw)
            else:
                b = bound_ms(nbytes, flops)
                d = rows["qgemm_t" if name == "K7" else "qgemm"].d
                d["max_abs_err"] = max(d["max_abs_err"], err)
                d.setdefault("family_m2048", {})[label] = dict(
                    ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1], library_ms=lib)
            log(f"    {name} {label}: kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
                f"torch.matmul on the dequantized weight {lib * 1e3:.1f} us, bound "
                f"{b[0] * 1e3:.2f} us ({b[1]}); the kernel at {b[0] / ms:.1%} of its bound, "
                f"{ms / lib:.2f}x the library")
        if is_family:
            del p
            torch.cuda.empty_cache()
    k7.d["per"] = f"one training layer's backward: qkv + o + upgate + down at M={m}"
    # ragged M: the last block of rows is partly past M
    p = layers["o"].layer(3)
    x, gy = randn(m - 1, p.in_features), randn(m - 1, p.out_features)
    tail = matmul_f32(gy, p.oweight.t())
    k2.d["max_abs_err"] = max(k2.d["max_abs_err"], check(
        f"K2 o M={m - 1}", qmm.qgemm(x, p), qmm.qgemm_plain(f32(x), f32(p))))
    k7.d["max_abs_err"] = max(k7.d["max_abs_err"], check(
        f"K7 o M={m - 1}", qmm.qgemm_t(gy, p, tail), qmm.qgemm_t_plain(f32(gy), f32(p), tail)))
    row = rows["qgemm"].d
    row["max_abs_err"] = max(row["max_abs_err"], k2.d["max_abs_err"])
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        row[f"train_{key}"] = k2.d[key]
    row["train_per"] = f"one training layer's forward: qkv + o + upgate + down at M={m}"
    log(f"[train-kernels] per layer: K7 {k7.d['ms']:.3f} ms (bound {k7.d['bound_ms']:.3f}: "
        f"{k7.d['bound_ms'] / k7.d['ms']:.1%}; torch.matmul {k7.d['library_ms']:.3f}), K2 "
        f"{k2.d['ms']:.3f} ms (bound {k2.d['bound_ms']:.3f}: {k2.d['bound_ms'] / k2.d['ms']:.1%}; "
        f"torch.matmul {k2.d['library_ms']:.3f})")


def phase_train_grad(cfg, params):
    """The autograd linear on the full upgate stage: dx (K7 + addend) and
    the f32 dow against autograd through the plain version in f32."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.ops.qlinear import qlinear_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    p = params["layers"]["upgate"].layer(5)
    m = TRAIN_BATCH * TRAIN_SEQ
    x = torch.randn(m, p.in_features, generator=gen, device="cuda").to(torch.bfloat16)
    gy = torch.randn(m, p.out_features, generator=gen, device="cuda").to(torch.bfloat16)
    ow = p.oweight.float().requires_grad_()
    xk = x.clone().requires_grad_()
    qlinear_apply(xk, dataclasses.replace(p, oweight=ow)).backward(gy)
    x32 = x.float().requires_grad_()
    ow32 = ow.detach().clone().requires_grad_()
    qmm.qgemm_plain(x32, dataclasses.replace(f32(p), oweight=ow32)).backward(gy.float())
    log(f"[train-grad] autograd linear, upgate layer 5, M={m}, vs autograd of the plain version")
    check("dx", xk.grad, x32.grad)
    check("dow (f32)", ow.grad, ow32.grad)
    if ow.grad.dtype != torch.float32:
        raise AssertionError("the oweight gradient is not f32")


def phase_train_oracle(cfg, params):
    """One batch through the kernel path and through the dense bf16 model
    (plain PyTorch, same training forward): losses within LOSS_RTOL (both
    bf16 through 32 layers; a wrong kernel moves the loss by O(1)), and the
    dense weight's gradient on its last r rows -- which is the oweight
    gradient -- within ORACLE_RTOL of its scale (as the serving oracle's
    bound: bf16 rounding through 32 layers of backward, where a wrong K7
    moves gradients by their own scale)."""
    from qeft_tpu_torch.finetune import causal_lm_loss, split_wct, wct_loss
    from qeft_tpu_torch.models.llama import llama_forward_train
    from qeft_tpu_torch.testing import dense_model

    ids, labels = next(_sft_batches(cfg))
    oweights, frozen = split_wct(params)
    loss_k = wct_loss(oweights, frozen, ids, labels, cfg, remat=True)
    loss_k.backward()
    dense = dense_model(params)
    for name in ("qkv", "o", "upgate", "down"):
        leaves = list(dense["layers"][name].unbind(0))
        for l in ORACLE_LAYERS:
            leaves[l] = leaves[l].detach().requires_grad_()
        dense["layers"][name] = leaves
    loss_d = causal_lm_loss(llama_forward_train(dense, ids, cfg, remat=True), labels)
    loss_d.backward()
    lk, ld = loss_k.item(), loss_d.item()
    log(f"[train-oracle] batch {TRAIN_BATCH}x{TRAIN_SEQ}: loss kernel path {lk:.6f}, dense "
        f"{ld:.6f}, |diff| {abs(lk - ld):.3g} (bound {LOSS_RTOL * ld:.3g})")
    ok = abs(lk - ld) <= LOSS_RTOL * ld
    out = {}
    for name in ("qkv", "o", "upgate", "down"):
        r = params["layers"][name].n_outlier
        for l in ORACLE_LAYERS:
            gd = dense["layers"][name][l].grad[-r:].float()
            gk = oweights[name][l].grad
            err, scale = (gk - gd).abs().max().item(), gd.abs().max().item()
            good = bool(torch.isfinite(gk).all()) and scale > 0 and err <= ORACLE_RTOL * scale
            ok &= good
            out[f"{name}{l}"] = err / scale
            log(f"  dow {name} layer {l}: max |diff| {err:.4g}, dense scale {scale:.4g} "
                f"({err / scale:.2%}) {'ok' if good else 'FAIL'}")
    del dense, oweights, frozen
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the training kernel path disagrees with the dense model")
    return dict(loss_kernel=lk, loss_dense=ld, grad_rel_err=out)


def _packed_linears(params, family):
    """(the stacked packed linears of a layer by name, the names of those
    that read the embedding at layer 0: the qkv stage)."""
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.ops.packing import QLinearParams

    lins = {k: v for k, v in params["layers"].items() if isinstance(v, QLinearParams)}
    first = [k for k in lins if k in get_model_meta(family).qkv + ("qkv",)]
    return lins, first


def phase_family_train_oracle(cfg, params, family, label):
    """The training oracle of a family: one TRAIN_BATCH x TRAIN_SEQ batch
    through the kernel path, through the dense bf16 model (plain PyTorch,
    the same training forward) and through the dense model in f32 (every
    leaf and activation f32: the reference the two bf16 paths round away
    from).  The loss within LOSS_RTOL of the dense bf16 model's, as
    phase_train_oracle bounds it.  Each weak-column slab's gradient at
    ORACLE_LAYERS: the kernel path's relative Frobenius error against the
    f32 model within GRAD_RATIO times the dense bf16 model's own (a kernel
    adds no error beyond bf16's; a wrong kernel moves a gradient by its own
    scale); Llama's comparison, max |diff| against the dense bf16 model over
    its scale, printed beside it.  For OPT's ReLU fc1 no bf16 path comes
    within 0.1 of the scale of the f32 gradient (PERF.md §6), so a
    bound on it would hold the kernels to what bf16 cannot give.

    The oracle is then read with planted faults, K7's ``dx`` scaled by each
    of FAULTS_DX in every layer's backward: it must reject the first; the
    largest ratio of the sound run and of each faulted one are printed and
    returned, so that GRAD_RATIO is seen to lie between them."""
    from qeft_tpu_torch.checkpoint import tree_map
    from qeft_tpu_torch.finetune import causal_lm_loss, split_wct, wct_loss
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.ops import qlinear
    from qeft_tpu_torch.testing import dense_model

    names = list(_packed_linears(params, family)[0])
    ids, labels = next(_sft_batches(cfg))
    loss, grads = {}, {}
    real_qgemm_t = qlinear.qgemm_t
    faults = [f"dx x {f}" for f in FAULTS_DX]
    for tag, scale in (("kernel", None), *zip(faults, FAULTS_DX)):
        if scale is not None:
            qlinear.qgemm_t = lambda *a, **kw: real_qgemm_t(*a, **kw) * scale
        try:
            oweights, frozen = split_wct(params)
            loss[tag] = wct_loss(oweights, frozen, ids, labels, cfg, remat=True, family=family)
            loss[tag].backward()
        finally:
            qlinear.qgemm_t = real_qgemm_t
        grads[tag] = {(n, l): oweights[n][l].grad.float() for n in names
                      for l in ORACLE_LAYERS}
        del oweights, frozen
    for tag, dtype in (("dense bf16", torch.bfloat16), ("dense f32", torch.float32)):
        dense = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                         dense_model(params, dtype))
        for n in names:
            leaves = list(dense["layers"][n].unbind(0))
            for l in ORACLE_LAYERS:
                leaves[l] = leaves[l].detach().requires_grad_()
            dense["layers"][n] = leaves
        loss[tag] = causal_lm_loss(get_model_api(family).forward_train(dense, ids, cfg, True),
                                   labels)
        loss[tag].backward()
        r = params["layers"][names[0]].n_outlier
        grads[tag] = {(n, l): dense["layers"][n][l].grad[-r:].float() for n in names
                      for l in ORACLE_LAYERS}
        del dense
        torch.cuda.empty_cache()
    lk, ld, lf = (loss[t].item() for t in ("kernel", "dense bf16", "dense f32"))
    log(f"[{label}] batch {TRAIN_BATCH}x{TRAIN_SEQ}: loss kernel path {lk:.6f}, dense bf16 "
        f"{ld:.6f}, dense f32 {lf:.6f}; |kernel - dense bf16| {abs(lk - ld):.3g} (bound "
        f"{LOSS_RTOL * ld:.3g})")
    ok = abs(lk - ld) <= LOSS_RTOL * ld
    out = {}

    def fro(a, b):
        return ((a - b).norm() / b.norm()).item()

    def max_rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    ratios = {tag: [] for tag in ["kernel", *faults]}
    for (n, l), gf in grads["dense f32"].items():
        gk, gd = grads["kernel"][(n, l)], grads["dense bf16"][(n, l)]
        ek, ed = fro(gk, gf), fro(gd, gf)
        for tag in ratios:
            ratios[tag].append(fro(grads[tag][(n, l)], gf) / ed)
        good = bool(torch.isfinite(gk).all()) and ek <= GRAD_RATIO * ed
        ok &= good
        out[f"{n}{l}"] = dict(kernel_vs_f32=ek, bf16_vs_f32=ed, max_vs_bf16=max_rel(gk, gd),
                              max_kernel_vs_f32=max_rel(gk, gf), max_bf16_vs_f32=max_rel(gd, gf),
                              ratios={tag: r[-1] for tag, r in ratios.items()})
        log(f"  dow {n} layer {l}: against the f32 model, relative Frobenius error kernel path "
            f"{ek:.2%}, dense bf16 {ed:.2%}: ratio {ek / ed:.3f} (bound {GRAD_RATIO:.2f}; "
            + ", ".join(f"{tag} {ratios[tag][-1]:.3f}" for tag in faults)
            + f"); max |diff| over the scale: kernel vs dense bf16 {max_rel(gk, gd):.2%} "
            f"(Llama's comparison), kernel vs f32 {max_rel(gk, gf):.2%}, dense bf16 vs f32 "
            f"{max_rel(gd, gf):.2%} {'ok' if good else 'FAIL'}")
    largest = {tag: max(r) for tag, r in ratios.items()}
    caught = {tag: sum(x > GRAD_RATIO for x in ratios[tag]) for tag in faults}
    log(f"[{label}] largest ratio (bound {GRAD_RATIO:.2f}): sound {largest['kernel']:.3f}; "
        + "; ".join(f"K7's {tag} {largest[tag]:.3f}, failing {caught[tag]} of "
                    f"{len(ratios[tag])} slabs" for tag in faults))
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{label}: the training kernel path disagrees with the dense model")
    if not caught[faults[0]]:
        raise AssertionError(f"{label}: the oracle passed a K7 with {faults[0]}")
    return dict(loss_kernel=lk, loss_dense=ld, loss_f32=lf, largest_ratio=largest,
                slabs_failed=caught, grads=out)


def train_step_flops(cfg, params, family="llama") -> int:
    """Operations of one train step as the port runs it: each packed linear
    forward twice (remat) over K + r rows, K7 over K rows except layer 0's
    qkv stage, the two weak-column products; the plain attention's four
    products forward, recomputed and twice backward; lm_head forward and its
    dx."""
    m, s = TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ
    lins, first = _packed_linears(params, family)
    per_layer = 0
    for p in lins.values():
        k, n, r = p.in_features, p.out_features, p.n_outlier
        per_layer += 2 * (2 * m * (k + r) * n) + 2 * m * k * n + 2 * (2 * m * r * n)
    per_layer += 4 * (4 * TRAIN_BATCH * cfg.num_heads * s * s * cfg.head_dim)
    head = 2 * (2 * m * params["lm_head"].shape[0] * cfg.vocab_size)
    no_dx = sum(2 * m * lins[k].in_features * lins[k].out_features for k in first)
    return cfg.num_layers * per_layer - no_dx + head


def phase_train(cfg, params, family="llama", label="train", steps=TRAIN_STEPS):
    """The WCT main path: ``steps`` steps of make_train_step with
    run_finetune's defaults (lr 2e-4, cosine over 100 steps, warmup 0.03,
    clip 0.3, remat), launch counts checked per step: K2 twice for every
    packed linear (the forward and its recomputation), K7 once but for the
    qkv stage of layer 0, whose input (the embedding) needs no gradient."""
    from torch.profiler import ProfilerActivity, profile

    from qeft_tpu_torch.finetune import (
        TrainConfig, leaves, make_optimizer, make_train_step, split_wct,
    )
    from qeft_tpu_torch.ops import cuda_lib

    oweights, frozen = split_wct(params)
    frozen_copy = {k: (v.map(torch.clone) if hasattr(v, "map") else v.clone())
                   for k, v in frozen["layers"].items()}
    start = [t.detach().clone() for t in leaves(oweights)]
    tc = TrainConfig(learning_rate=2e-4, total_steps=100, warmup_ratio=0.03,
                     max_grad_norm=0.3, lr_schedule="cosine", remat=True)
    opt = make_optimizer(tc, oweights)
    step = make_train_step(cfg, opt, remat=True, family=family)
    data = _sft_batches(cfg)
    n_layers, tokens = cfg.num_layers, TRAIN_BATCH * TRAIN_SEQ
    lins, first = _packed_linears(params, family)
    per_step = {"qgemm": 2 * len(lins) * n_layers, "qgemm_t": len(lins) * n_layers - len(first)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    losses, host_ms, dev_ms = [], [], []
    for i in range(steps):
        ids, labels = next(data)
        before = dict(cuda_lib.launches)
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        tick = time.perf_counter()
        start_ev.record()
        loss = step(oweights, frozen, ids, labels)
        end_ev.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - tick) * 1e3)
        dev_ms.append(start_ev.elapsed_time(end_ev))
        losses.append(loss.item())
        diff = {k: cuda_lib.launches[k] - before.get(k, 0) for k in cuda_lib.launches}
        diff = {k: v for k, v in diff.items() if v}
        supervised = int((labels[:, 1:] != -100).sum())
        log(f"[{label}] step {i + 1}: loss {losses[-1]:.6f}, {host_ms[-1]:.1f} ms host clock, "
            f"{dev_ms[-1]:.1f} ms CUDA events, {tokens / host_ms[-1] * 1e3:.0f} tokens/s "
            f"({supervised} supervised), launches {diff}")
        if diff != per_step:
            raise AssertionError(f"step {i + 1} launched {diff}, expected {per_step}")
    counts = dict(cuda_lib.launches)
    PATH_LAUNCHES[label] = counts
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * steps for k, v in per_step.items()}
    log(f"[{label}] launches {counts}; expected {want} ({per_step} a step); peak device memory "
        f"{peak:.3f} GB")
    if counts != want:
        raise AssertionError("the training path did not launch each kernel as expected")
    med_host, med_dev = statistics.median(host_ms[1:]), statistics.median(dev_ms[1:])
    flops = train_step_flops(cfg, params, family)
    log(f"[{label}] steps 2-{steps}: median {med_host:.1f} ms host clock, {med_dev:.1f} ms "
        f"CUDA events -> {tokens / med_host * 1e3:.0f} tokens/s; {flops / 1e12:.2f} TFLOP a step, "
        f"bound {flops / PEAK_BF16 * 1e3:.1f} ms (operations)")
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError("a training loss is not finite")
    moved = max((a.detach() - b).abs().max().item() for a, b in zip(leaves(oweights), start))
    for k, v in frozen["layers"].items():
        same = ([torch.equal(getattr(v, f), getattr(frozen_copy[k], f))
                 for f in ("qweight", "scales", "scaled_zeros")] if hasattr(v, "map")
                else [torch.equal(v, frozen_copy[k])])
        if not all(same):
            raise AssertionError(f"frozen buffer {k} changed")
    log(f"[{label}] oweights moved by up to {moved:.4g}; frozen buffers unchanged")
    if not moved > 0:
        raise AssertionError("the oweights did not move")
    del frozen_copy, start

    ids, labels = next(data)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(oweights, frozen, ids, labels)
        torch.cuda.synchronize()
    kernels, busy = kernel_times(prof)
    res = dict(losses=losses, host_ms=med_host, dev_ms=med_dev, tokens_s=tokens / med_host * 1e3,
               peak_gb=peak, counts=counts, per_step=per_step)
    if busy == 0:
        log(f"[{label}] device time not measured (the profiler recorded no CUDA kernel)")
        return res
    log(f"[{label}] profiled step: device busy {busy:.1f} ms against the median unprofiled step "
        f"{med_host:.1f} ms (host clock) -> idle share {max(0.0, 1 - busy / med_host):.1%}; "
        f"top kernels:")
    for name, ms in kernels[:10]:
        log(f"    {ms:9.3f} ms  {ms / busy:6.1%}  {name[:90]}")
    res.update(busy_ms=busy, idle=max(0.0, 1 - busy / med_host))
    return res


def phase_cli(cfg):
    """run_finetune and main on a 4-layer model of full width: save at
    step 2, resume (as if cut after that save) to step 4, then serve the
    tuned checkpoint through K1-K4."""
    from qeft_tpu_torch import main as cli
    from qeft_tpu_torch import run_finetune
    from qeft_tpu_torch.checkpoint import save_packed
    from qeft_tpu_torch.ops import cuda_lib
    from qeft_tpu_torch.testing import build_packed_model

    small = dataclasses.replace(cfg, num_layers=4)
    with tempfile.TemporaryDirectory() as tmp:
        tick = time.perf_counter()
        base = os.path.join(tmp, "llama2_7b_4layers_packed")
        save_packed(base, build_packed_model(small, seed=5, g=128, r=128, device="cuda"), small)
        log(f"[cli] save_packed of a 4-layer full-width model: "
            f"{os.path.getsize(base + '.npz')} bytes in {time.perf_counter() - tick:.1f} s")
        out = os.path.join(tmp, "wct")
        argv = ["--load", base, "--output_dir", out, "--log_steps", "1"]
        run_finetune.main(argv + ["--max_steps", "3", "--save_steps", "2"])
        names = sorted(os.listdir(out))
        log(f"[cli] run_finetune to step 3 wrote {names}")
        for need in ("wct_step2.npz", "opt_step2.pt", "wct_final.npz", "metrics.json", "completed"):
            if need not in names:
                raise AssertionError(f"run_finetune did not write {need}")
        os.remove(os.path.join(out, "completed"))
        metrics = run_finetune.main(argv + ["--max_steps", "4", "--save_steps", "2"])
        steps = [m["step"] for m in metrics if "loss" in m]
        log(f"[cli] resumed run logged steps {steps}")
        if steps != [1, 2, 3, 4]:
            raise AssertionError("the resumed run did not continue from step 2 to step 4")
        cuda_lib.reset_launches()
        res = cli.main(["--load", os.path.join(out, "wct_final"), "--eval", "--eval_windows", "1",
                        "--seqlen", "512", "--benchmark", "32"])
        counts = dict(cuda_lib.launches)
        log(f"[cli] main on the tuned checkpoint: {res}; launches {counts}")
        for k in ("qgemv_stacked_fused", "qgemm", "flash_window_attention", "decode_attention"):
            if not counts.get(k):
                raise AssertionError(f"serving the tuned model launched no {k}")
        if not res["ppl_synthetic"] == res["ppl_synthetic"]:
            raise AssertionError("PPL of the tuned model is not finite")
    return res


# ---------------------------------------------------------------------------
# serving beyond single-sequence bf16 decoding


class counted:
    """The launch counts of one main path: every count set to 0 just before
    it runs and read just after, kept in PATH_LAUNCHES under ``name``."""

    def __init__(self, name: str):
        self.name = name
        self.counts = {}

    def __enter__(self):
        from qeft_tpu_torch.ops import cuda_lib

        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        return self

    def __exit__(self, *exc):
        from qeft_tpu_torch.ops import cuda_lib

        torch.cuda.synchronize()
        self.counts = dict(cuda_lib.launches)
        if exc[0] is None:
            PATH_LAUNCHES[self.name] = self.counts
        return False


def _dequant(codes, scales):
    return (codes.float() * scales[..., None]).to(torch.bfloat16)


def phase_serving_kernels(cfg, params, bw, rows):
    """K6 against its plain version evaluated in f32 at M = 1, 4 and 8 (the
    engine's slots), timed beside its bound and ``torch.matmul`` on a
    pre-dequantized weight."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.testing import dense_linear

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    n_layers = cfg.num_layers
    k6 = rows["qgemv_stacked"] = Row("qgemv_stacked", "qeft_tpu_torch/csrc/qmm.cu",
                                     "qeft_tpu/ops/pallas_qmm.py:258", True)
    layers = params["layers"]
    log(f"[serving-kernels] K6 qgemv_stacked vs plain, M in (1, 4, {ENGINE_SLOTS}), layer "
        "rotating over 32 (cold weights)")
    by_m = {m: Row("qgemv_stacked", "", "", True) for m in (1, 4)}  # merged into the row below
    by_m[ENGINE_SLOTS] = k6
    for name in ("qkv", "o", "upgate", "down"):
        p = layers[name]
        k, n, r = p.in_features, p.out_features, p.n_outlier
        w = dense_linear(_one_layer(p, 0))[0]
        for m, row in by_m.items():
            x = randn(m, k)
            err = check(f"K6 {name} {k}->{n} M={m}", qmm.qgemv_stacked(x, p, 3),
                        qmm.qgemv_stacked_plain(f32(x), f32(p), 3))
            ms = time_ms(lambda i: qmm.qgemv_stacked(x, p, i % n_layers))
            plain = (time_ms(lambda i: qmm.qgemv_stacked_plain(x, p, i % n_layers), inner=2,
                             reps=3) if m == ENGINE_SLOTS else 0.0)
            lib = time_ms(lambda i: torch.matmul(x, w))
            nbytes = k * n // 2 + 4 * (k // p.group_size) * n + 2 * r * n + 2 * m * (k + n)
            b = row.add(err, ms, plain, lib, nbytes, 2 * m * (k + r) * n, bw)
            log(f"    M={m}: kernel {ms * 1e3:.1f} us ({b[0] / ms:.1%} of the bound), "
                + (f"plain {plain * 1e3:.1f} us, " if plain else "")
                + f"torch.matmul on the dequantized weight {lib * 1e3:.1f} us, bound "
                f"{b[0] * 1e3:.2f} us ({b[1]})")
        del w
    k6.d["per"] = (f"one engine decode layer: qkv + o + upgate + down at M={ENGINE_SLOTS} "
                   "(m1_*, m4_*: M = 1, 4; no plain time)")
    for m in (1, 4):
        for key in ("ms", "bound_ms", "library_ms"):
            k6.d[f"m{m}_{key}"] = by_m[m].d[key]
        k6.d["max_abs_err"] = max(k6.d["max_abs_err"], by_m[m].d["max_abs_err"])
    log("[serving-kernels] K6 per Llama-2-7B layer: " + ", ".join(
        f"M={m} {r.d['ms'] * 1e3:.1f} us ({r.d['bound_ms'] / r.d['ms']:.1%} of the bound "
        f"{r.d['bound_ms'] * 1e3:.2f}; torch.matmul {r.d['library_ms'] * 1e3:.1f})"
        for m, r in sorted(by_m.items())))


def _counted_generate(cfg, params, prompt, name, quantized=False):
    """``generate`` over a fresh cache after a short warm-up, as main path
    ``name``; returns (tokens, launches, seconds)."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api("llama")

    def new_cache():
        return api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda",
                              quantized=quantized)

    generate(params, prompt, new_cache(), cfg, 8, api=api, device="cuda")
    cache = new_cache()
    with counted(name) as c:
        tick = time.perf_counter()
        tokens, _ = generate(params, prompt, cache, cfg, NEW_TOKENS, api=api, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    if tokens.shape != (1, NEW_TOKENS) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{name}: generated tokens out of range")
    return tokens, c.counts, dt


def _against_bf16_path(cfg, params, prompt, tokens, label, quantized):
    """The generated tokens teacher-forced through the path that made them
    and through the bf16-cache path (K1-K4); max logit difference within
    ORACLE_RTOL of the bf16 path's logit scale."""
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api("llama")
    got = _teacher_forced(params, cfg, api, prompt, tokens, quantized=quantized)
    with environ(QEFT_ATTN_STACKED="0"):
        ref = _teacher_forced(params, cfg, api, prompt, tokens)
    diff = (got - ref).abs().amax(dim=-1)
    scale = ref.abs().amax().item()
    worst = diff.max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).sum().item()
    log(f"[{label}] teacher-forced against the bf16-cache path: max |logit diff| {worst:.4g}, "
        f"median {diff.median().item():.4g}, logit scale {scale:.4g}, bound "
        f"{ORACLE_RTOL * scale:.4g}; argmax agreement {agree}/{NEW_TOKENS}")
    if not (torch.isfinite(got).all() and worst <= ORACLE_RTOL * scale):
        raise AssertionError(f"{label}: disagrees with the bf16-cache path")
    return dict(max_logit_diff=worst, logit_scale=scale, argmax_agree=agree)


def phase_int8_generate(cfg, params, prompt):
    """``generate`` over an int8 cache: K4q at every decode step."""
    tokens, counts, dt = _counted_generate(cfg, params, prompt, "int8 generate", quantized=True)
    steps, n = NEW_TOKENS - 1, cfg.num_layers
    want = {"qgemv_stacked_fused": 4 * n * steps, "decode_attention_int8": n * steps,
            "qgemm": 4 * n, "flash_window_attention": n}
    log(f"[int8] generate over a {CACHE}-slot int8 cache: {NEW_TOKENS / dt:.2f} tok/s, "
        f"{dt / NEW_TOKENS * 1e3:.3f} ms/token (host clock); launches {counts}; expected {want}")
    if counts != want:
        raise AssertionError("the int8 path did not launch each kernel as expected")
    res = _against_bf16_path(cfg, params, prompt, tokens, "int8", quantized=True)
    return dict(tok_s=NEW_TOKENS / dt, tokens=tokens, seconds=dt, **res)


def phase_stacked_generate(cfg, params, prompt):
    """``generate`` with QEFT_ATTN_STACKED=1 over bf16 and int8 caches: K8
    at every decode step, K4 and K4q never."""
    out = {}
    steps, n = NEW_TOKENS - 1, cfg.num_layers
    want = {"qgemv_stacked_fused": 4 * n * steps, "decode_attention_stacked": n * steps,
            "qgemm": 4 * n, "flash_window_attention": n}
    for quantized in (False, True):
        label = f"stacked {'int8' if quantized else 'bf16'}"
        with environ(QEFT_ATTN_STACKED="1"):
            tokens, counts, dt = _counted_generate(cfg, params, prompt, f"{label} generate",
                                                   quantized=quantized)
            log(f"[{label}] generate: {NEW_TOKENS / dt:.2f} tok/s, "
                f"{dt / NEW_TOKENS * 1e3:.3f} ms/token (host clock); launches {counts}; "
                f"expected {want}")
            if counts != want:
                raise AssertionError(f"{label}: did not launch each kernel as expected")
            res = _against_bf16_path(cfg, params, prompt, tokens, label, quantized)
        out[label] = dict(tok_s=NEW_TOKENS / dt, tokens=tokens, seconds=dt, **res)
    return out


# ---------------------------------------------------------------------------
# the decode loop as one CUDA graph, and the probes (P1-P4)


@torch.inference_mode()
def _graph_step_profile(family, cfg, params, prompt, quantized=False, steps=16):
    """Host clock per step and device busy time (torch.profiler) of
    ``steps`` replays of the captured decode step after a prefill; the idle
    share is what the busy time leaves of the host clock."""
    from torch.profiler import ProfilerActivity, profile

    from qeft_tpu_torch.generate import DecodeLoop, SampleConfig
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api(family)
    cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda", quantized=quantized)
    logits, cache = api.prefill(params, prompt, cache, cfg)
    tokens = torch.zeros(1, 2 * steps + 2, dtype=torch.int64, device="cuda")
    tokens[:, 0] = logits[:, -1].argmax(-1)
    loop = DecodeLoop(api, params, cache, cfg, tokens, PROMPT, SampleConfig(), None)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        loop.step()
    graph = loop.capture(stream)
    torch.cuda.synchronize()
    tick = time.perf_counter()
    graph.replay(steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - tick) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay(steps)
        torch.cuda.synchronize()
    kernels, busy = kernel_times(prof, steps)
    return wall, busy, kernels


def _graph_case(label, family, cfg, params, prompt, tokens, seconds, quantized=False):
    """The eager decode loop (``generate(graph=False)``) on the model and
    prompt a graph-run ``generate`` took ``seconds`` for: tokens identical;
    tok/s of both, and the graph step's host clock, busy time and idle
    share."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api(family)
    n = min(tokens.shape[1], GRAPH_EAGER_TOKENS)
    cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda", quantized=quantized)
    torch.cuda.synchronize()
    tick = time.perf_counter()
    eager, _ = generate(params, prompt, cache, cfg, n, api=api, device="cuda", graph=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - tick
    same = torch.equal(eager, tokens[:, :n])
    wall, busy, kernels = _graph_step_profile(family, cfg, params, prompt, quantized)
    idle = "not measured" if busy == 0 else f"{max(0.0, 1 - busy / wall):.1%}"
    log(f"[graph] {label}: graph {tokens.shape[1] / seconds:.2f} tok/s ({PROMPT} + "
        f"{tokens.shape[1]}), eager loop {n / dt:.2f} tok/s ({PROMPT} + {n}; host clock, prefill "
        f"included); graph step {wall:.3f} ms host clock, device busy {busy:.3f} ms -> idle "
        f"share {idle}; the first {n} tokens identical to the eager loop's: {same}")
    for name, ms in kernels[:4]:
        log(f"    {ms * 1e3:9.1f} us  {name[:90]}")
    if not same:
        raise AssertionError(f"{label}: the graph and the eager loop chose other tokens")
    return dict(graph_tok_s=tokens.shape[1] / seconds, eager_tok_s=n / dt, graph_step_ms=wall,
                busy_ms=busy,
                idle=None if busy == 0 else max(0.0, 1 - busy / wall))


def phase_graph(cfg, params, prompt, runs, bw, rows):
    """P1 [A], [B], [C] (``probes.entry_overhead``) on the full model, then
    each Llama ``generate`` of the phases before -- bf16, int8, stacked bf16
    and int8 -- against the eager loop (``runs``: label -> (tokens, seconds,
    quantized, stacked))."""
    from qeft_tpu_torch.probes import entry_overhead as p1

    with counted("graph probe"):
        res = p1.measure(params, cfg, torch.device("cuda"))
    p1.print_summary(res, cfg)
    e = res["entry"]
    row = rows["add_one"] = Row("add_one", "qeft_tpu_torch/csrc/probes.cu",
                                "scripts/entry_overhead_probe.py:67", True)
    row.add(0.0, e["kernel graph"]["device_us"] * 1e-3, e["torch.add eager"]["device_us"] * 1e-3,
            e["torch.add graph"]["device_us"] * 1e-3, 2 * 8 * 128 * 4, 0, bw)
    row.d.update(eager_host_us=e["kernel eager"]["host_us"],
                 eager_device_us=e["kernel eager"]["device_us"],
                 graph_host_us=e["kernel graph"]["host_us"], graph_pairs=res["pairs"],
                 eager_parts_host_us=res["parts"],
                 per=("one entry of a chain of 512 in a CUDA graph (CUDA events); plain: torch.add "
                      "eagerly, library: torch.add in a graph; exact"))
    out = {"p1": res}
    for label, (tokens, seconds, quantized, stacked) in runs.items():
        with environ(QEFT_ATTN_STACKED="1" if stacked else "0"):
            out[label] = _graph_case(label, "llama", cfg, params, prompt, tokens, seconds,
                                     quantized)
    return out


# P2 and P3 of another checkout (the parent commit's), measured in a
# subprocess from its root: the same measure functions, its own kernels
_PARENT_PROBES = ("import json, torch\n"
                  "from qeft_tpu_torch.probes import dma, dma2\n"
                  "d = torch.device('cuda')\n"
                  "print(json.dumps({'p2': dma.measure(d), 'p3': dma2.measure(d)}))")


def _parent_probes(parent):
    root = os.path.abspath(parent)
    run = subprocess.run([sys.executable, "-c", _PARENT_PROBES], cwd=root, capture_output=True,
                         text=True, timeout=900, env={**os.environ, "PYTHONPATH": root})
    if run.returncode != 0:
        raise RuntimeError(f"the parent's probes failed:\n{run.stdout[-2000:]}{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def phase_probes(bw, rows, parent=None):
    """P2, P3 and P4 at their scripts' shapes: each kernel against its plain
    version (P2 and P3 exact, P4 within KERNEL_RTOL of the output's scale),
    timed hot (one buffer, as the scripts run them) and cold (rotating over
    copies past 200 MB), beside the plain version, one PyTorch call where
    one computes the same function and the bound (unpack_only also beside
    the issue bound of its hot loop's instructions, read from the built
    library's SASS); K6 and K1 at P4's shapes.  ``parent``: the root of
    another checkout (the parent commit's), whose P2 and P3 are timed the
    same way in a subprocess before and after this checkout's, in this call."""
    from qeft_tpu_torch.probes import dma, dma2
    from qeft_tpu_torch.probes import gemv_ablation as p4

    dev = torch.device("cuda")
    par = [_parent_probes(parent)] if parent else []
    with counted("probes"):
        r2, r3, r4 = dma.measure(dev), dma2.measure(dev), p4.measure(dev)
    if parent:
        par.append(_parent_probes(parent))

    def beside(times, pick):
        """``times``' hot and cold µs beside the parent's (before / after)."""
        line = f"hot {times['hot_ms'] * 1e3:.2f} us, cold {times['cold_ms'] * 1e3:.2f} us"
        if par:
            ts = [pick(p) for p in par]
            line += (" (parent hot " + " / ".join(f"{t['hot_ms'] * 1e3:.2f}" for t in ts)
                     + ", cold " + " / ".join(f"{t['cold_ms'] * 1e3:.2f}" for t in ts) + " us)")
        return line

    def parent_times(pick):
        return [{k: pick(p)[k] for k in ("hot_ms", "cold_ms")} for p in par]

    src = "qeft_tpu_torch/csrc/probes.cu"
    bound2 = r2["bytes"] / PEAK_HBM * 1e3
    for name, line, lib in (("dma_only", 18, True), ("unpack_only", 52, False)):
        t = r2[name]
        row = rows[name] = Row(name, src, f"scripts/dma_probe.py:{line}", lib)
        row.add(t["max_abs_err"], t["cold_ms"], t["plain_ms"], t.get("library_ms"), r2["bytes"], 0,
                bw)
        row.d.update(hot_ms=t["hot_ms"], hot_GBps=t["hot_GBps"], cold_GBps=t["cold_GBps"],
                     per=f"one launch over [{dma.K8}, {dma.N}] int32 words, cold (hot_ms: one "
                         "buffer); exact" + ("; library: qw.sum(0)" if lib else ""))
        if par:
            row.d["parent"] = parent_times(lambda p, name=name: p["p2"][name])
        extra = ""
        if name == "unpack_only":
            i = t["issue"]
            row.d.update(issue_bound_ms=t["issue_bound_ms"], int_bound_ms=i["int_bound_ms"],
                         instructions_a_word=i["per_word"], plan=t["plan"],
                         in_flight_per_sm=t["in_flight_per_sm"])
            extra = (f"; issue bound {t['issue_bound_ms'] * 1e3:.2f} us ({i['instructions']} "
                     f"instructions for {i['words']:.0f} words in the hot loop, "
                     f"{i['per_word']:.2f} a word, 4 a clock an SM at {i['clock_hz'] / 1e6:.0f} "
                     f"MHz; {i['opcodes']}), integer bound {i['int_bound_ms'] * 1e3:.2f} us "
                     f"({i['int_per_word']:.2f} LOP3/SHF/IADD3 a word at 64 lanes a clock an SM)")
        log(f"[probes] P2 {name}: {beside(t, lambda p, name=name: p['p2'][name])}; "
            f"{t['hot_GBps']:.0f} / {t['cold_GBps']:.0f} GB/s; plain {t['plain_ms'] * 1e3:.1f} us"
            + (f", qw.sum(0) {t['library_ms'] * 1e3:.2f} us" if lib else "")
            + f"; bytes bound {bound2 * 1e3:.2f} us{extra}; exact")
    row = rows["dma_tile"] = Row("dma_tile", src, "scripts/dma_probe2.py:19", True)
    t = r3["bn512"]
    row.add(t["max_abs_err"], t["cold_ms"], r3["plain_ms"], r3["library_ms"], r3["bytes"], 0, bw)
    row.d.update(hot_ms=t["hot_ms"], by_bn={bn: {k: r3[f"bn{bn}"][k] for k in (
        "hot_ms", "cold_ms", "hot_GBps", "cold_GBps", "plan", "in_flight_per_sm")}
        for bn in dma2.BNS},
        per=f"one launch over [{dma.K8}, {dma.N}] int32 words at bn = 512, cold; exact; "
            "library: torch.add(qw[:8], s), which reads only the 8 rows the result needs")
    if par:
        row.d["parent"] = {bn: parent_times(lambda p, bn=bn: p["p3"][f"bn{bn}"])
                           for bn in dma2.BNS}
    for bn in dma2.BNS:
        t = r3[f"bn{bn}"]
        plan = t["plan"]
        log(f"[probes] P3 dma_tile bn={bn}: {beside(t, lambda p, bn=bn: p['p3'][f'bn{bn}'])}; "
            f"{t['hot_GBps']:.0f} / {t['cold_GBps']:.0f} GB/s; grid {plan['tiles']} x "
            f"{plan['splits']}, {plan['rows_per_block']} rows a block in stages of "
            f"{plan['stage_rows']}, {plan['stages']} slots, {t['in_flight_per_sm'] // 1024} KB in "
            f"flight an SM; bytes bound {r3['bound_ms'] * 1e3:.2f} us; exact")
    log(f"[probes] P3 plain {r3['plain_ms'] * 1e3:.2f} us, torch.add(qw[:8], s) "
        f"{r3['library_ms'] * 1e3:.2f} us")
    _p4_row(r4, rows, bw)
    return dict(p2=r2, p3=r3, p4=r4, parent=par)


def _p4_row(r4, rows, bw):
    """P4's row of the table from `gemv_ablation.measure`'s result: v0_full
    cold at both shapes, every variant's times beside it, and the port's K6
    and K1 at the same shapes (K1 where the measuring checkout times it)."""
    from qeft_tpu_torch.probes import gemv_ablation as p4

    row = rows["gemv_ablation"] = Row("gemv_ablation", "qeft_tpu_torch/csrc/probes.cu",
                                      "scripts/gemv_ablation_probe.py:140", True)
    for label, r in r4.items():
        t = r["v0_full"]
        row.add(max(r[v]["max_abs_err"] for v in p4.VARIANTS), t["cold_ms"], r["plain_ms"],
                r["library_ms"], r["bytes"], 2 * p4.M * r["K"] * r["N"], bw)
        log(f"[probes] P4 {label}: bound {r['bound_ms'] * 1e3:.2f} us; torch.matmul on the "
            f"dequantized weight {r['library_ms'] * 1e3:.1f} us; plain v0_full "
            f"{r['plain_ms'] * 1e3:.1f} us" + "".join(
                f"; {key.upper()} M=8 hot {r[key]['hot_ms'] * 1e3:.1f} us, cold "
                f"{r[key]['cold_ms'] * 1e3:.1f} us (bound {r[key]['bound_ms'] * 1e3:.2f} us)"
                for key in ("k6", "k1") if key in r))
        for v in p4.VARIANTS:
            t = r[v]
            log(f"    {v:11s} hot {t['hot_ms'] * 1e3:7.1f} us, cold {t['cold_ms'] * 1e3:7.1f} us "
                f"({t['cold_GBps']:.0f} GB/s of words), max_abs_err {t['max_abs_err']:.4g}")
    row.d.update(per=("v0_full at down 11008->4096 + qkv 4096->12288, M=8, g=128, cold; every "
                      "variant within KERNEL_RTOL of its plain version"),
                 variants={label: {v: {k: r[v][k] for k in ("hot_ms", "cold_ms")}
                                   for v in p4.VARIANTS} for label, r in r4.items()},
                 **{key: {label: r[key] for label, r in r4.items()}
                    for key in ("k6", "k1") if all(key in r for r in r4.values())})


def _engine_prompts(cfg):
    """measure_engine_throughput's requests at its defaults (seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=ENGINE_CTX) for _ in range(ENGINE_REQUESTS)]


@torch.inference_mode()
def _check_served(cfg, params, prompts, outputs, label, quantized, exact=False):
    """Each request's tokens teacher-forced through the single-sequence path
    (prefill, then decode steps at one shared position; all requests have
    the same lengths, so they run as one batch): at every step the served
    token's logit is within ORACLE_RTOL of the logit scale of the best
    logit, and with ``exact`` it is the best (greedy speculative decoding
    must emit the target's own greedy tokens).  Then single-sequence greedy
    ``generate`` of the same prompts: agreement printed."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api

    api = get_model_api("llama")
    b, gen = len(prompts), len(outputs[0])
    prompt = torch.as_tensor(np.stack(prompts), device="cuda")
    served = torch.as_tensor(outputs, device="cuda")
    cache = api.init_cache(cfg, b, ENGINE_CTX + gen, dtype=torch.bfloat16, device="cuda",
                           quantized=quantized)
    logits, cache = api.prefill(params, prompt, cache, cfg)
    regret, agree, scale = [], 0, 0.0
    for i in range(gen):
        if i:
            logits, cache = api.decode_step(params, served[:, i - 1: i], cache,
                                            ENGINE_CTX + i - 1, cfg)
        lf = (logits[:, -1] if logits.dim() == 3 else logits).float()
        regret.append(lf.amax(-1) - lf.gather(1, served[:, i: i + 1])[:, 0])
        agree += int((lf.argmax(-1) == served[:, i]).sum())
        scale = max(scale, lf.abs().amax().item())
    worst = torch.stack(regret).max().item()
    ref, _ = generate(params, prompt, api.init_cache(cfg, b, ENGINE_CTX + gen, dtype=torch.bfloat16,
                                                     device="cuda", quantized=quantized),
                      cfg, gen, api=api, device="cuda")
    same = (ref == served)
    prefix = same.long().cumprod(1).sum(1)
    log(f"[{label}] {b} requests teacher-forced through the single-sequence path: served token "
        f"is the argmax at {agree}/{b * gen} steps; worst shortfall of its logit below the best "
        f"{worst:.4g} (logit scale {scale:.4g}, bound {ORACLE_RTOL * scale:.4g}); greedy "
        f"generate agrees on {int(same.sum())}/{b * gen} tokens, common prefixes "
        f"{prefix.tolist()}")
    if worst > ORACLE_RTOL * scale or (exact and agree != b * gen):
        raise AssertionError(f"{label}: a served token is not the single-sequence path's choice")
    return dict(tf_argmax_agree=agree, tf_steps=b * gen, worst_shortfall=worst, logit_scale=scale,
                generate_agree=int(same.sum()))


def phase_engine(cfg, params):
    """Continuous batching over bf16 and int8 caches: one counted serve of
    ``measure_engine_throughput``'s default requests (8 slots, 16 requests
    of 64-token prompts, 128 new tokens each, burst 16) -- the measurement
    (the function itself runs in phase serving-cli, through ``run_benchmark
    --method engine``) -- with launches per tick, each
    request checked against the single-sequence path."""
    from qeft_tpu_torch.serving import Engine, Request

    out = {}
    n = cfg.num_layers
    for label, env in (("engine bf16", {}), ("engine int8", {"QEFT_KV_DTYPE": "int8"})):
        with environ(**env):
            prompts = _engine_prompts(cfg)
            eng = Engine(params, cfg, max_batch=ENGINE_SLOTS, max_len=ENGINE_CTX + ENGINE_GEN + 1,
                         burst=16, device="cuda")
            for i, p in enumerate(prompts):
                eng.submit(Request(request_id=i, prompt=p, max_new_tokens=ENGINE_GEN))
            with counted(label) as c:
                tick = time.perf_counter()
                done = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - tick
            ticks, tokens = eng.ticks, sum(len(r.output) for r in done)
            want = {"qgemv_stacked": 4 * n * ticks, "qgemm": 4 * n * ENGINE_REQUESTS,
                    "flash_window_attention": n * (ticks + ENGINE_REQUESTS)}
            per_tick = {k: v / ticks for k, v in c.counts.items()}
            log(f"[{label}] one serve: {len(done)} requests, {tokens} tokens in {wall:.3f} s -> "
                f"{tokens / wall:.2f} tokens/s, {ticks} ticks, {wall / ticks * 1e3:.3f} ms per tick "
                f"(host clock, prefill included); launches {c.counts} (per tick {per_tick}); "
                f"expected {want}")
            if c.counts != want or len(done) != ENGINE_REQUESTS:
                raise AssertionError(f"{label}: did not launch each kernel as expected")
            outputs = [r.output for r in sorted(done, key=lambda r: r.request_id)]
            if any(len(o) != ENGINE_GEN for o in outputs):
                raise AssertionError(f"{label}: a request was not served in full")
            SERVED[label] = outputs
            res = _check_served(cfg, params, prompts, outputs, label, bool(env))
            if not env:  # one profiled burst, over bf16 (time budget)
                res.update(_profile_burst(cfg, params, prompts, label))
        out[label] = dict(serve_tokens_s=tokens / wall, ms_per_tick=wall / ticks * 1e3,
                          ticks=ticks, launches_per_tick=per_tick, **res)
    return out


@torch.inference_mode()
def _profile_burst(cfg, params, prompts, label):
    """Device busy time and idle share of one engine burst (16 ticks) with
    all 8 slots decoding: the burst after admission, run once unprofiled
    (host clock) and once under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from qeft_tpu_torch.serving import Engine, Request

    eng = Engine(params, cfg, max_batch=ENGINE_SLOTS, max_len=ENGINE_CTX + ENGINE_GEN + 1,
                 burst=16, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, prompt=p, max_new_tokens=ENGINE_GEN))
    eng.step()  # admission (8 prefills) and the first burst
    torch.cuda.synchronize()
    tick = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - tick) * 1e3 / 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    kernels, busy = kernel_times(prof, 16)
    if busy == 0:
        log(f"[{label}] burst: {wall:.3f} ms per tick; device time not measured (the profiler "
            "recorded no CUDA kernel)")
        return dict(tick_wall_ms=wall)
    log(f"[{label}] burst of 16 ticks, 8 slots decoding: {wall:.3f} ms per tick (host clock, "
        f"unprofiled), device busy {busy:.3f} ms -> idle share {max(0.0, 1 - busy / wall):.1%}; "
        "top kernels per tick:")
    for name, ms in kernels[:8]:
        log(f"    {ms * 1e3:9.1f} us  {ms / busy:6.1%}  {name[:90]}")
    k3 = sum(ms for name, ms in kernels if "flash" in name)
    log(f"[{label}] K3 (flash_window_attention, 32 launches a tick): {k3 * 1e3:.1f} us per tick, "
        f"{k3 / busy:.1%} of the device busy time, {k3 / wall:.1%} of the host clock")
    return dict(tick_wall_ms=wall, tick_busy_ms=busy, tick_k3_ms=k3)


def phase_spec(cfg, params):
    """Speculative serving with a self-draft of 8 of the 32 layers, gamma 4:
    ``SpecEngine`` over the engine's 16 requests and
    ``speculative_generate_batched`` at B = 4; the greedy output must be the
    target's own greedy choice at every step under teacher forcing."""
    from qeft_tpu_torch.models.llama import init_kv_cache
    from qeft_tpu_torch.serving import Request, SpecEngine
    from qeft_tpu_torch.speculative import layer_sliced_draft, speculative_generate_batched

    gamma = 4
    draft, dcfg = layer_sliced_draft(params, cfg, SPEC_DRAFT_LAYERS)
    prompts = _engine_prompts(cfg)
    out = {}
    eng = SpecEngine(params, cfg, draft, dcfg, gamma=gamma, max_batch=ENGINE_SLOTS,
                     max_len=ENGINE_CTX + ENGINE_GEN + gamma + 2, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, prompt=p, max_new_tokens=ENGINE_GEN))
    with counted("spec engine") as c:
        tick = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tick
    tokens = sum(len(r.output) for r in done)
    accept = eng.accepted_total / max(eng.slot_rounds, 1)
    log(f"[spec engine] self-draft {dcfg.num_layers} layers, gamma {gamma}: {len(done)} requests, "
        f"{tokens} tokens in {wall:.3f} s -> {tokens / wall:.2f} tokens/s (host clock), "
        f"{eng.rounds_total} rounds, mean accept length {accept:.3f} of {gamma}; launches "
        f"{c.counts}")
    for k in ("qgemv_stacked", "qgemm", "flash_window_attention"):
        if not c.counts.get(k):
            raise AssertionError(f"spec engine: launched no {k}")
    outputs = [r.output for r in sorted(done, key=lambda r: r.request_id)]
    if len(done) != ENGINE_REQUESTS or any(len(o) != ENGINE_GEN for o in outputs):
        raise AssertionError("spec engine: a request was not served in full")
    res = _check_served(cfg, params, prompts, outputs, "spec engine", False, exact=True)
    out["spec engine"] = dict(tokens_s=tokens / wall, rounds=eng.rounds_total,
                              mean_accept_length=accept, **res)

    b = 4
    slots = ENGINE_CTX + ENGINE_GEN + gamma + 1
    prompt = torch.as_tensor(np.stack(prompts[:b]), device="cuda")
    caches = [init_kv_cache(c, b, slots, device="cuda") for c in (cfg, dcfg)]
    with counted("spec batched") as c:
        tick = time.perf_counter()
        toks, tel = speculative_generate_batched(params, draft, prompt, *caches, cfg, dcfg,
                                                 ENGINE_GEN, gamma=gamma, greedy=True,
                                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - tick
    accept, rounds = float(tel["mean_accept_length"]), int(tel["rounds"])
    log(f"[spec batched] B={b}, {ENGINE_GEN} tokens each in {wall:.3f} s -> "
        f"{b * ENGINE_GEN / wall:.2f} tokens/s (host clock), {rounds} rounds, mean accept length "
        f"{accept:.3f}; launches {c.counts}")
    res = _check_served(cfg, params, prompts[:b], toks.tolist(), "spec batched", False,
                        exact=True)
    out["spec batched"] = dict(tokens_s=b * ENGINE_GEN / wall, rounds=rounds,
                               mean_accept_length=accept, **res)
    return out


def phase_serving_cli():
    """``run_benchmark --method engine`` and ``--method spec-batch
    --draft_layers 8`` at full width and depth, one timed run each."""
    import io

    from qeft_tpu_torch import run_benchmark

    lines = {}
    for method, extra in (("engine", []), ("spec-batch", ["--draft_layers", str(SPEC_DRAFT_LAYERS)])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = run_benchmark.main(["--method", method, "--reps", "1", "--gen",
                                      str(SERVING_CLI_GEN)] + extra)
        line = buf.getvalue().strip().splitlines()[-1]
        log(f"[serving-cli] run_benchmark --method {method} {' '.join(extra)}: {line}")
        if json.loads(line) != res:
            raise AssertionError(f"run_benchmark --method {method} printed another result")
        lines[method] = res
        torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# the other families: OPT-6.7B at full depth; Phi-2, Bloom-7b1 and Falcon-7b
# at full width and 2 layers -- every linear at decode through K5


def phase_opt_model(cfg):
    from qeft_tpu_torch.testing import build_packed_model

    tick = time.perf_counter()
    params = build_packed_model(cfg, seed=0, g=128, r=128, device="cuda", family="opt")
    torch.cuda.synchronize()
    top = [params[k] for k in ("final_ln", "final_ln_b", "lm_head")]
    nbytes = sum(t.numel() * t.element_size() for t in [*_leaves(params["layers"]), *top])
    log(f"[opt-model] random packed opt-6.7b ({cfg.num_layers} layers, w4/g128/r128) on the card "
        f"in {time.perf_counter() - tick:.1f} s; {nbytes} bytes of layers, final norm and lm_head")
    return params, nbytes


def _check_layer0(label, layers, rows):
    """Every packed linear of layer 0 of a family model as its main path runs
    it -- the input gathered by the linear's ``reorder_ids``, if it has
    them, and K5 with the ``<name>_b`` bias in its epilogue -- against the
    plain versions evaluated in f32: K5 at M = 1 (a decode step) and K2 at
    M = PROMPT (the prefill).  Not counted on any main path."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.ops.packing import QLinearParams

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for name, lin in layers.items():
        if not isinstance(lin, QLinearParams):
            continue
        p = lin.layer(0)
        x = torch.randn(PROMPT, p.in_features, generator=gen, device="cuda").to(torch.bfloat16)
        if p.reorder_ids is not None:
            x = x.index_select(-1, p.reorder_ids)
        p = dataclasses.replace(p, reorder_ids=None)
        bias = layers.get(name + "_b")
        pb = dataclasses.replace(p, bias=None if bias is None else bias[0])
        shape = (f"{p.in_features}->{p.out_features} g={p.group_size}"
                 f"{' bias' if bias is not None else ''}"
                 f"{' reorder_ids' if lin.reorder_ids is not None else ''}")
        e5 = check(f"{label} layer 0 {name} {shape}: K5 M=1", qmm.qgemv(x[:1], pb),
                   qmm.qgemv_plain(f32(x[:1]), f32(pb)))
        e2 = check(f"{label} layer 0 {name} {shape}: K2 M={PROMPT}", qmm.qgemm(x, p),
                   qmm.qgemm_plain(f32(x), f32(p)))
        for key, err in (("qgemv", e5), ("qgemm", e2)):
            rows[key].d["max_abs_err"] = max(rows[key].d["max_abs_err"], err)


def phase_family_kernels(cfg, params, bw, rows):
    """K5 against its plain version evaluated in f32 at the OPT-6.7B stage
    shapes (the row: one decode layer at M = 1, bias on, as the main path
    runs it), every linear of layer 0 through K5 and K2 as `_check_layer0`
    holds it, K5 at Falcon-7b's four stage shapes at M = 8 (`_k5_stage_rows`)
    and K1 / K6 at eight rows of wide K."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.testing import dense_linear, random_packed_linear

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    layers, n_layers = params["layers"], cfg.num_layers
    k5 = rows["qgemv"] = Row("qgemv", "qeft_tpu_torch/csrc/qmm.cu",
                             "qeft_tpu/ops/pallas_qmm.py:599", True)
    k5_m8 = Row("qgemv", "", "", True)  # M = 8, merged into the row below
    log("[family-kernels] K5 qgemv vs plain at the OPT-6.7B stage shapes, M in (1, 8), with and "
        f"without bias, layer rotating over {n_layers} (cold weights)")
    for name in OPT_LINEARS:
        p, bias = layers[name], layers[name + "_b"]
        k, n, r = p.in_features, p.out_features, p.n_outlier

        def lin(i, with_bias=True):
            return dataclasses.replace(p.layer(i % n_layers),
                                       bias=bias[i % n_layers] if with_bias else None)

        w = dense_linear(_one_layer(p, 0))[0]
        for m, row in ((1, k5), (8, k5_m8)):
            x = randn(m, k)
            err = max(check(f"K5 {name} {k}->{n} M={m}{' bias' if b else ''}",
                            qmm.qgemv(x, lin(3, b)), qmm.qgemv_plain(f32(x), f32(lin(3, b))))
                      for b in (False, True))
            ms = time_ms(lambda i: qmm.qgemv(x, lin(i)))
            plain = time_ms(lambda i: qmm.qgemv_plain(x, lin(i)), inner=2, reps=3)
            lib = time_ms(lambda i: torch.addmm(bias[0], x, w))
            nbytes = k * n // 2 + 4 * (k // p.group_size) * n + 2 * r * n + 2 * n + 2 * m * (k + n)
            b = row.add(err, ms, plain, lib, nbytes, 2 * m * (k + r) * n, bw)
            log(f"    M={m}: kernel {ms * 1e3:.1f} us ({b[0] / ms:.1%} of the bound), plain "
                f"{plain * 1e3:.1f} us, torch.addmm on the dequantized weight {lib * 1e3:.1f} us, "
                f"bound {b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
        del w
    k5.d["per"] = "one OPT-6.7B decode layer: q + k + v + o + fc1 + fc2 at M=1, bias on (m8_*: M=8)"
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        k5.d[f"m8_{key}"] = k5_m8.d[key]
    k5.d["max_abs_err"] = max(k5.d["max_abs_err"], k5_m8.d["max_abs_err"])
    log("[family-kernels] K5 per OPT layer: " + ", ".join(
        f"M={m} {r.d['ms'] * 1e3:.1f} us ({r.d['bound_ms'] / r.d['ms']:.1%} of the bound "
        f"{r.d['bound_ms'] * 1e3:.2f}; torch.addmm {r.d['library_ms'] * 1e3:.1f})"
        for m, r in ((1, k5), (8, k5_m8))))
    _check_layer0("opt-6.7b", layers, rows)
    log("[family-kernels] K5 at the Falcon-7b stage shapes, M = 8, g = 64 (random weights)")
    _k5_stage_rows(bw, rows, [s for s in K5_STAGES if s[0].startswith("falcon")])

    from qeft_tpu_torch.pipeline import rtn_pack_linear

    k, n = 4096, 32000
    log(f"[family-kernels] K5 on the packed lm_head of llama2-7b ({k} -> {n}, round-to-nearest "
        "g=128, no weak columns: QEFT_QUANT_LMHEAD), M in (1, 8)")
    head = rtn_pack_linear(torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5)
    w = dense_linear(head.map(lambda t: t[None]))[0]
    for m in (1, 8):
        x = randn(m, k)
        err = check(f"K5 lm_head {k}->{n} M={m}", qmm.qgemv(x, head),
                    qmm.qgemv_plain(f32(x), f32(head)))
        ms = time_ms(lambda i: qmm.qgemv(x, head))
        plain = time_ms(lambda i: qmm.qgemv_plain(x, head), inner=2, reps=3)
        lib = time_ms(lambda i: torch.mm(x, w))
        nbytes = k * n // 2 + 4 * (k // 128) * n + 2 * m * (k + n)
        b = bound_ms(nbytes, 2 * m * k * n)
        k5.d["max_abs_err"] = max(k5.d["max_abs_err"], err)
        k5.d.update({f"head_m{m}_ms": ms, f"head_m{m}_plain_ms": plain,
                     f"head_m{m}_library_ms": lib, f"head_m{m}_bound_ms": b[0]})
        log(f"    M={m}: kernel {ms * 1e3:.1f} us ({b[0] / ms:.1%} of the bound), plain "
            f"{plain * 1e3:.1f} us, torch.mm on the dequantized weight {lib * 1e3:.1f} us, bound "
            f"{b[0] * 1e3:.2f} us ({b[1]}: {nbytes} B)")
    del head, w

    n = 4096
    log(f"[family-kernels] K1 and K6 at M=8, N={n}, K up to 28,672")
    for k in WIDE_K:
        p = random_packed_linear(gen, 2, k, n, 128, 128)
        x, res = randn(8, k), randn(8, n, scale=4.0)
        lnw = (1.0 + randn(k, scale=0.1).float()).to(torch.bfloat16)
        kw = dict(lnw=lnw, residual=res, eps=1e-5)
        e1 = check(f"K1 M=8 K={k}", qmm.qgemv_stacked_fused(x, p, 1, **kw),
                   qmm.qgemv_stacked_fused_plain(f32(x), f32(p), 1, lnw=f32(lnw),
                                                 residual=f32(res), eps=1e-5))
        e6 = check(f"K6 M=8 K={k}", qmm.qgemv_stacked(x, p, 1),
                   qmm.qgemv_stacked_plain(f32(x), f32(p), 1))
        ms1 = time_ms(lambda i: qmm.qgemv_stacked_fused(x, p, i % 2, **kw))
        ms6 = time_ms(lambda i: qmm.qgemv_stacked(x, p, i % 2))
        nbytes = k * n // 2 + 4 * (k // 128) * n + 2 * 128 * n + 2 * 8 * (k + n)
        b = bound_ms(nbytes, 2 * 8 * (k + 128) * n)
        for key, err, ms in (("qgemv_stacked_fused", e1, ms1), ("qgemv_stacked", e6, ms6)):
            d = rows[key].d
            d["max_abs_err"] = max(d["max_abs_err"], err)
            d.setdefault("wide_k_m8_ms", {})[k] = ms
            d.setdefault("wide_k_m8_bound_ms", {})[k] = b[0]
        log(f"    K={k}: K1 {ms1 * 1e3:.1f} us, K6 {ms6 * 1e3:.1f} us, bound {b[0] * 1e3:.2f} us "
            f"({b[1]})")
        del p


def _decode_attention_launches(family, cfg, steps):
    """The K4 launches of ``steps`` decode steps of a ``family`` model on the
    card with a bf16 cache: one a layer and step where the family's decode
    route holds (``common.decode_route``), else none."""
    import importlib

    from qeft_tpu_torch.models.common import decode_route

    dec = importlib.import_module(f"qeft_tpu_torch.models.{family}").DECODER
    if decode_route(1, torch.bfloat16, torch.bfloat16, "cuda", cfg.head_dim, dec.score_bias):
        return {"decode_attention": cfg.num_layers * steps}
    return {}


def _family_generate(family, cfg, params, new_tokens, label):
    """``generate`` (prompt 64, ``new_tokens`` greedy, batch 1, 320-slot bf16
    cache) after a short warm-up, with the launch counts of path ``label``
    checked: K5 for every linear of every decode step, K2 for every linear
    of the prefill, K4 for every layer of every decode step where the
    family's decode route holds (``common.decode_route``), nothing else.
    -> (prompt, tokens, seconds)."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.registry import get_model_meta

    api = get_model_api(family)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device="cuda")

    def new_cache():
        return api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")

    generate(params, prompt, new_cache(), cfg, 8, api=api, device="cuda")  # warm-up
    cache = new_cache()
    with counted(label) as c:
        tick = time.perf_counter()
        tokens, _ = generate(params, prompt, cache, cfg, new_tokens, api=api, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    linears = len(get_model_meta(family).all_linears) * cfg.num_layers
    want = {"qgemv": linears * (new_tokens - 1), "qgemm": linears,
            **_decode_attention_launches(family, cfg, new_tokens - 1)}
    log(f"[{label}] prefill {PROMPT} + {new_tokens} greedy tokens in {dt:.3f} s -> "
        f"{new_tokens / dt:.2f} tok/s, {dt / new_tokens * 1e3:.3f} ms/token (host clock, decode "
        f"loop as CUDA graph replays); launches {c.counts}; expected {want}")
    if c.counts != want:
        raise AssertionError(f"{label}: did not launch each kernel as expected")
    if tokens.shape != (1, new_tokens) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: generated tokens out of range")
    return prompt, tokens, dt


def _dense_oracle(label, family, cfg, params, prompt, tokens):
    """The generated tokens teacher-forced through the kernel path and the
    dense bf16 model it stands for (plain PyTorch, decode attention too:
    ``QEFT_PALLAS_ATTN=0``): max logit difference per step within
    ORACLE_RTOL of the dense logit scale, as phase_oracle bounds it; the
    greedy agreement is that of the two argmaxes at each step."""
    from qeft_tpu_torch import env
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.testing import dense_model

    api = get_model_api(family)
    dense = dense_model(params)
    lk = _teacher_forced(params, cfg, api, prompt, tokens)
    with env.setting(QEFT_PALLAS_ATTN="0"):
        ld = _teacher_forced(dense, cfg, api, prompt, tokens)
    del dense
    torch.cuda.empty_cache()
    diff = (lk - ld).abs().amax(dim=-1)
    scale, worst = ld.abs().amax().item(), diff.max().item()
    agree = (lk.argmax(-1) == ld.argmax(-1)).sum().item()
    log(f"[{label}] teacher-forced max |logit diff| {worst:.4g}, median "
        f"{diff.median().item():.4g}, dense logit scale {scale:.4g}, bound "
        f"{ORACLE_RTOL * scale:.4g}; greedy (argmax) agreement {agree}/{tokens.shape[1]}")
    if not (torch.isfinite(lk).all() and worst <= ORACLE_RTOL * scale):
        raise AssertionError(f"{label}: the kernel path disagrees with the dense model")
    return dict(max_logit_diff=worst, logit_scale=scale, argmax_agree=agree)


def phase_opt(cfg, params, nbytes):
    """OPT-6.7B's main path: ``generate`` at full depth, a profiled decode
    step and prefill, the dense-model oracle."""
    prompt, tokens, dt = _family_generate("opt", cfg, params, NEW_TOKENS, "opt generate")
    graph = _graph_case("opt-6.7b", "opt", cfg, params, prompt, tokens, dt)
    per_token = nbytes + 2 * cfg.num_layers * cfg.hidden_size * 2 * (PROMPT + NEW_TOKENS / 2)
    log(f"[opt generate] bytes/token about {per_token:.0f} (weights, final norm, lm_head and the "
        f"mean cached K/V) -> {per_token / (dt / NEW_TOKENS) / 1e9:.1f} GB/s achieved")
    prof = phase_profile(cfg, params, prompt, family="opt", tag="opt-profile")
    res = _dense_oracle("opt oracle", "opt", cfg, params, prompt, tokens)
    return dict(tok_s=NEW_TOKENS / dt, ms_token=dt / NEW_TOKENS * 1e3, profile=prof, graph=graph,
                **res)


def phase_families(rows):
    """Phi-2, Bloom-7b1 and Falcon-7b at full width and FAMILY_LAYERS layers:
    each built on the card, its layer-0 linears held against the plain
    versions (`_check_layer0`), generated from and checked against its
    dense model."""
    import importlib

    from qeft_tpu_torch.testing import build_packed_model

    out = {}
    for family, preset, g, reorder in FAMILY_RUNS:
        module = importlib.import_module(f"qeft_tpu_torch.models.{family}")
        cfg = dataclasses.replace(getattr(module, f"{family.upper()}_PRESETS")[preset],
                                  num_layers=FAMILY_LAYERS)
        tick = time.perf_counter()
        params = build_packed_model(cfg, seed=0, g=g, r=128, device="cuda", family=family,
                                    reorder=reorder)
        torch.cuda.synchronize()
        log(f"[{preset}] random packed {preset} at {FAMILY_LAYERS} layers (w4/g{g}/r128, "
            f"{'o_reorder' if reorder else 'per-linear reorder_ids'}) built in "
            f"{time.perf_counter() - tick:.1f} s")
        _check_layer0(preset, params["layers"], rows)
        prompt, tokens, dt = _family_generate(family, cfg, params, FAMILY_NEW,
                                              f"{preset} generate")
        graph = _graph_case(preset, family, cfg, params, prompt, tokens, dt)
        out[preset] = dict(tok_s=FAMILY_NEW / dt, graph=graph,
                           **_dense_oracle(f"{preset} oracle", family, cfg, params, prompt,
                                           tokens))
        del params
        torch.cuda.empty_cache()
    return out


def phase_family_cli(cfg):
    """``main --load --eval --benchmark`` and ``run_benchmark --method qeft
    --load`` on a FAMILY_LAYERS-layer OPT-6.7B written with ``save_packed``,
    each in its own process."""
    from qeft_tpu_torch.checkpoint import save_packed
    from qeft_tpu_torch.testing import build_packed_model

    small = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS)
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "opt_6.7b_2layers_packed")
        save_packed(base, build_packed_model(small, seed=5, g=128, r=128, device="cuda",
                                             family="opt"), small, family="opt")
        torch.cuda.empty_cache()
        runs = {"main": ["-m", "qeft_tpu_torch.main", "--load", base, "--eval",
                         "--eval_windows", "1", "--seqlen", "512", "--benchmark", "64"],
                "run_benchmark": ["-m", "qeft_tpu_torch.run_benchmark", "--method", "qeft",
                                  "--load", base]}
        tick = time.perf_counter()
        procs = {label: subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True, cwd=root)
                 for label, argv in runs.items()}  # the two run together
        try:
            for label, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                log(f"[family-cli] python {' '.join(runs[label][:2])} --load <2-layer "
                    f"opt-6.7b> ... exit {proc.returncode}, {time.perf_counter() - tick:.1f} s "
                    "after both started:")
                for line in stdout.strip().splitlines()[-4:]:
                    log(f"    {line}")
                if proc.returncode != 0:
                    log(stderr[-3000:])
                    raise AssertionError(f"{label} on an OPT checkpoint failed")
                out[label] = stdout
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    if "family opt" not in out["main"] or "synthetic ppl" not in out["main"]:
        raise AssertionError("main did not serve the OPT checkpoint as OPT")
    if not json.loads(out["run_benchmark"].strip().splitlines()[-1])["tokens_per_s"] > 0:
        raise AssertionError("run_benchmark reported no throughput")
    return out


def _expect(label, counts, want):
    log(f"[quantize] {label}: launches {counts}; expected {want}")
    if counts != want:
        raise AssertionError(f"{label}: did not launch each kernel as expected")


def _quantize_breakdown(dense, calib, cfg, meta, args):
    """Where a block's quantization time goes (block 0, host clock to a
    synchronisation): its calibration forwards (all four Hessians, and the
    re-forward), the GPTQ of each linear with its group re-fits
    (`gptq_quantize`) as replays of the captured column programs (one
    capture per linear shape, kept across the linears as `quantize_model`
    keeps them), those of BREAKDOWN_EAGER also eagerly (``graph=False``,
    each kernel launched from the host) and held bit-identical; one group's
    MSE grid and the Frobenius weighting of o and down.  Then the profiler
    over q's column loop, eager and captured: device busy time against the
    host clock a column, and the kernels a column block launches."""
    from torch.profiler import ProfilerActivity, profile

    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.quant import gptq, outliers, quantizer

    def timed_s(fn):
        torch.cuda.synchronize()
        tick = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - tick, res

    blk = {k: v[0] for k, v in pl._member_layers(dense, cfg, meta).items()}
    inps = get_model_api(meta.family).embed(dense, torch.as_tensor(calib, device="cuda"), cfg)
    t = {}
    t["hessian forward"], (_, hs) = timed_s(lambda: pl.block_hessians(blk, inps, cfg, meta))
    t["re-forward"], _ = timed_s(lambda: pl.block_forward_batch(blk, inps, cfg, meta))
    num, loops, eager_s, columns, inputs = 40, gptq.ColumnLoops(), {}, 0, {}
    for name in meta.all_linears:
        h = hs[pl._stage_of(meta, name)] * (2.0 / args.nsamples)
        w = blk[name].t().float()
        ids, out_ids = outliers.hessian_sort_ids(torch.diagonal(h), 128)
        inputs[name] = (w, h, ids, out_ids)
        columns += w.shape[1] - 128
        t[f"gptq {name}"], got = timed_s(lambda: gptq.gptq_quantize(
            w, h, args.spec, ids, out_ids, num=num, loops=loops))
        if name in BREAKDOWN_EAGER:
            eager_s[name], want = timed_s(lambda: gptq.gptq_quantize(
                w, h, args.spec, ids, out_ids, num=num, graph=False))
            if not all(torch.equal(getattr(got, f), getattr(want, f))
                       for f in ("w_fake", "scale_group", "zero_group")):
                raise AssertionError(f"the captured GPTQ of {name} differs from the eager one")
        if name in meta.out + meta.ffn2:
            t[f"frobenius {name}"], _ = timed_s(
                lambda: outliers.frob_norm_error(w, args.spec, num=num))
    group = blk["up"].t()[:, :128].float()
    t["one mse group of up"], _ = timed_s(lambda: quantizer.find_params(group, args.spec, num))
    group = blk["q"].t()[:, :128].float()
    t["one mse group of q"], _ = timed_s(lambda: quantizer.find_params(group, args.spec, num))
    total = sum(v for k, v in t.items() if not k.startswith("one"))
    replays = sum(loop.replays for loop in loops.values())
    graphs = sum(len(loop.graphs) for loop in loops.values())
    log(f"[quantize] block 0's time by step (seconds; the GPTQ of a linear includes its group "
        f"re-fits, its column blocks replayed from {graphs} captured programs): "
        + ", ".join(f"{k} {v:.3f}" for k, v in t.items()) + f"; sum {total:.2f}")
    log(f"[quantize] the same GPTQ eagerly (graph=False): "
        + ", ".join(f"{k} {v:.3f}" for k, v in eager_s.items())
        + f" (captured: " + ", ".join(f"{n} {t[f'gptq {n}']:.3f}" for n in eager_s)
        + f"; bit-identical: {', '.join(eager_s)}); {replays} replays and "
        f"{columns // 128 - replays} eager column blocks (the captures' first runs) a block, "
        f"{columns} columns")
    w, h, ids, out_ids = inputs["q"]
    n_cols = w.shape[1] - 128
    prof_out = {}
    for label, kw in (("eager", dict(graph=False)), ("captured", dict(loops=loops))):
        gptq.gptq_quantize(w, h, args.spec, ids, out_ids, num=num, **kw)  # warm
        host_s, _ = timed_s(lambda: gptq.gptq_quantize(w, h, args.spec, ids, out_ids, num=num,
                                                       **kw))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gptq.gptq_quantize(w, h, args.spec, ids, out_ids, num=num, **kw)
            torch.cuda.synchronize()
        kernels, busy_ms = kernel_times(prof)
        n_kernels = sum(e.count for e in prof.key_averages()
                        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        prof_out[label] = dict(host_ms_a_column=host_s * 1e3 / n_cols,
                               busy_ms_a_column=busy_ms / n_cols, kernels=n_kernels,
                               kernels_a_block=n_kernels / (n_cols // 128))
        log(f"[quantize] q's GPTQ {label}: host clock {host_s * 1e3 / n_cols:.4f} ms a column "
            f"(unprofiled), device busy {busy_ms / n_cols:.4f} ms a column"
            + (f" (idle {max(0.0, 1 - busy_ms / (host_s * 1e3)):.1%})" if busy_ms else
               " (device time not measured: the profiler recorded no CUDA kernel)")
            + f"; {n_kernels} kernels, {n_kernels / (n_cols // 128):.0f} a column block; top: "
            + ", ".join(f"{k[:40]} {ms:.1f} ms" for k, ms in kernels[:4]))
    t["eager"] = eager_s
    t["profile_q"] = prof_out
    return t


def phase_quantize():
    """QEFT's own quantizer at full Llama-2-7B width: a random bf16 model of
    QUANT_LAYERS layers built on the card, OGR extraction (r = 128), GPTQ-OWQ
    with the global reorder (w4, g = 128, MSE grid) on QUANT_SAMPLES
    synthetic crops of QUANT_SEQ tokens (K3 in every calibration forward),
    save_fake, pack_model (stages fused), save_packed and both loads; then
    the reference's oracle -- fake-quant PPL against packed PPL, relative
    delta within PPL_RTOL -- teacher-forced logits of the packed model
    against the fake one (ORACLE_RTOL of the fake logits' scale), and
    ``generate`` (64 + 256) from the packed checkpoint through the graph,
    tokens equal to the eager loop's, with the dense head and with
    QEFT_QUANT_LMHEAD=1 (K5 for the head)."""
    from qeft_tpu_torch import checkpoint as ckpt
    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.data import get_calibration_tokens, get_loaders
    from qeft_tpu_torch.eval import eval_ppl
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.main import _eval_api, load_for_serving
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS, init_params
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.ops.packing import QLinearParams
    from qeft_tpu_torch.quant.quantizer import QuantSpec
    from qeft_tpu_torch.testing import dense_model

    cfg = dataclasses.replace(LLAMA_PRESETS[QUANT_PRESET], num_layers=QUANT_LAYERS)
    meta, api = get_model_meta("llama"), get_model_api("llama")
    n_layers, out = cfg.num_layers, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    calib = get_calibration_tokens("synthetic", QUANT_SAMPLES, 0, QUANT_SEQ,
                                   vocab_size=cfg.vocab_size)
    args = pl.QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=True, group_size=128),
                           target_rank=128, nsamples=QUANT_SAMPLES, no_frob_norm=True)
    log(f"[quantize] random bf16 {QUANT_PRESET} at {n_layers} layers (full width) on the card; "
        f"calibration {QUANT_SAMPLES} x {QUANT_SEQ} synthetic tokens; extraction r=128 (no "
        "Frobenius weighting), then GPTQ-OWQ w4 g128 MSE with the global reorder")
    k3 = n_layers * QUANT_SAMPLES  # one calibration forward of every block over every sample
    with counted("quantize extract") as c:
        tick = time.perf_counter()
        outidx, _ = pl.extract_global_outidx(dense, calib, cfg, meta, args)
        torch.cuda.synchronize()
        out["extract_s"] = time.perf_counter() - tick
    _expect("extraction", c.counts, {"flash_window_attention": k3})
    args.no_frob_norm = False  # the quantize step weights o and down by their Frobenius error
    with counted("quantize calibration") as c:
        tick = time.perf_counter()
        fake, states = pl.quantize_model(dense, calib, cfg, meta, args, outidx)
        torch.cuda.synchronize()
        out["quantize_s"] = time.perf_counter() - tick
    _expect("GPTQ calibration (Hessian forward + re-forward of each block)", c.counts,
            {"flash_window_attention": 2 * k3})
    log(f"[quantize] extraction {out['extract_s']:.1f} s, quantization {out['quantize_s']:.1f} s "
        f"({out['quantize_s'] / n_layers:.1f} s a block, the GPTQ column blocks replayed from "
        f"captured programs; each block's seconds printed above)")
    out["block_breakdown_s"] = _quantize_breakdown(dense, calib, cfg, meta, args)
    del dense
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        fake_path, packed_path = os.path.join(tmp, "q_fake"), os.path.join(tmp, "q_packed")
        ckpt.save_fake(fake_path, fake, states, cfg)
        tick = time.perf_counter()
        packed = pl.pack_model(fake, states, cfg, meta, fuse_stages=True)
        torch.cuda.synchronize()
        out["pack_s"] = time.perf_counter() - tick
        ckpt.save_packed(packed_path, packed, cfg)
        loaded, _, _ = ckpt.load_model(fake_path, device="cuda")
        served, _, _ = load_for_serving(packed_path, "cuda")
        with environ(QEFT_QUANT_LMHEAD="1"):
            served_head, _, _ = load_for_serving(packed_path, "cuda")
        sizes = {k: os.path.getsize(p + ".npz") for k, p in (("fake", fake_path),
                                                              ("packed", packed_path))}
    if not all(torch.equal(loaded["layers"][k], v) for k, v in fake["layers"].items()):
        raise AssertionError("the fake checkpoint did not load back bit for bit")
    if not all(torch.equal(getattr(served["layers"][k], f), getattr(v, f))
               for k, v in packed["layers"].items() if isinstance(v, QLinearParams)
               for f in ("qweight", "scales", "scaled_zeros", "oweight")):
        raise AssertionError("the packed checkpoint did not load back bit for bit")
    log(f"[quantize] pack_model {out['pack_s']:.2f} s; checkpoints {sizes} bytes; both loaded "
        "back bit for bit")
    fake_tree = pl.fuse_dense_stages(fake, meta)
    del fake, loaded, packed

    test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
    windows = QUANT_EVAL_WINDOWS
    recovered = dense_model(served)  # the fake model as the packed layout holds it
    ppl = {}
    for label, params, eval_api, want in (
            ("fake", fake_tree, _eval_api(fake_tree, "llama"),
             {"flash_window_attention": n_layers * windows}),
            ("recovered fake", recovered, _eval_api(recovered, "llama"),
             {"flash_window_attention": n_layers * windows}),
            ("packed", served, api,
             {"qgemm": 4 * n_layers * windows, "flash_window_attention": n_layers * windows})):
        with counted(f"quantize eval {label}") as c:
            ppl[label] = eval_ppl(params, test, cfg, seqlen=QUANT_SEQ, max_windows=windows,
                                  api=eval_api, device="cuda")
        _expect(f"eval of the {label} model", c.counts, want)
    del recovered
    delta = abs(ppl["packed"] - ppl["recovered fake"]) / ppl["recovered fake"]
    fake_delta = abs(ppl["packed"] - ppl["fake"]) / ppl["fake"]
    out.update(ppl_fake=ppl["fake"], ppl_recovered=ppl["recovered fake"],
               ppl_packed=ppl["packed"], ppl_delta=delta, ppl_delta_fake=fake_delta)
    log(f"[quantize] synthetic ppl ({windows} windows of {QUANT_SEQ}): fake {ppl['fake']:.4f}, "
        f"recovered fake (dequantized from the packed layout) {ppl['recovered fake']:.4f}, "
        f"packed {ppl['packed']:.4f}; fake-vs-packed delta {fake_delta:.4%} (printed: the "
        f"packed layout's bf16 scales and zero points move it), recovered-fake-vs-packed delta "
        f"{delta:.4%} (bound {PPL_RTOL:.2%})")
    if not (np.isfinite(ppl["fake"]) and np.isfinite(ppl["packed"]) and delta <= PPL_RTOL):
        raise AssertionError("the packed model's PPL disagrees with its fake model's")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device="cuda")
    steps = NEW_TOKENS - 1
    base = {"qgemv_stacked_fused": 4 * n_layers * steps, "decode_attention": n_layers * steps,
            "qgemm": 4 * n_layers, "flash_window_attention": n_layers}
    tokens = {}
    for label, params, want in (("dense head", served, base),
                                ("QEFT_QUANT_LMHEAD=1", served_head,
                                 {**base, "qgemv": steps, "qgemm": 4 * n_layers + 1})):
        def run(graph):
            cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")
            return generate(params, prompt, cache, cfg, NEW_TOKENS, api=api, device="cuda",
                            graph=graph)[0]

        run(True)  # warm-up: the capture
        with counted(f"quantize generate, {label}") as c:
            tick = time.perf_counter()
            got = run(True)
            torch.cuda.synchronize()
            dt = time.perf_counter() - tick
        _expect(f"generate from the packed checkpoint, {label}", c.counts, want)
        eager = run(False)
        same = bool(torch.equal(got, eager))
        log(f"[quantize] generate ({label}): {PROMPT} + {NEW_TOKENS} tokens in {dt:.3f} s -> "
            f"{NEW_TOKENS / dt:.2f} tok/s through the graph; tokens equal to the eager loop's: "
            f"{same}")
        if not same or not ((got >= 0) & (got < cfg.vocab_size)).all():
            raise AssertionError(f"generate ({label}): graph tokens differ from the eager loop's")
        tokens[label] = got
    lp = _teacher_forced(served, cfg, api, prompt, tokens["dense head"])
    lf = _teacher_forced(fake_tree, cfg, api, prompt, tokens["dense head"])
    lh = _teacher_forced(served_head, cfg, api, prompt, tokens["dense head"])
    diff, scale = (lp - lf).abs().amax(dim=-1), lf.abs().amax().item()
    out.update(max_logit_diff=diff.max().item(), logit_scale=scale,
               head_max_logit_diff=(lh - lf).abs().amax().item(),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[quantize] teacher-forced logits, packed vs fake: max |diff| {out['max_logit_diff']:.4g},"
        f" median {diff.median().item():.4g}, fake logit scale {scale:.4g}, bound "
        f"{ORACLE_RTOL * scale:.4g}; argmax agreement "
        f"{(lp.argmax(-1) == lf.argmax(-1)).sum().item()}/{NEW_TOKENS}; with the int4 head: max "
        f"|diff| {out['head_max_logit_diff']:.4g} (printed, not bounded: RTN int4 of the head)")
    if not (torch.isfinite(lp).all() and torch.isfinite(lh).all()
            and out["max_logit_diff"] <= ORACLE_RTOL * scale):
        raise AssertionError("the packed model's logits disagree with the fake model's")
    log(f"[quantize] peak device memory of the phase {out['peak_memory_gb']:.3f} GB")
    return out


def phase_quantize_cli():
    """The quantization CLIs as subprocesses on QUANT_CLI_PRESET (random f32
    weights on the card): extract_outidx, main quantize with --fake
    --packing --save and the fake-vs-packed oracle, convert (stages fused),
    main --load --eval --benchmark."""
    root = os.path.dirname(os.path.abspath(__file__))
    common = ["--model", QUANT_CLI_PRESET, "--wbits", "4", "--target_rank", "32", "--groupsize",
              "128", "--nsamples", "32"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        oidx = os.path.join(tmp, "oidx")
        save = os.path.join(tmp, "ckpt", "q")
        npy, logfile = os.path.join(tmp, "tokens.npy"), os.path.join(tmp, "runs.jsonl")
        np.save(npy, np.random.default_rng(4).integers(0, 512, 4096))  # tiny-v2's vocabulary
        for label, argv in (
                ("extract_outidx", ["-m", "qeft_tpu_torch.extract_outidx", *common,
                                    "--no_frob_norm", "--output_dir", oidx]),
                ("main", ["-m", "qeft_tpu_torch.main", *common, "--reorder", "--outidx_file",
                          os.path.join(oidx, "w4_r32", "outidx.npy"), "--fake", "--packing",
                          "--save", save, "--eval", "--eval_windows", "2"]),
                ("convert", ["-m", "qeft_tpu_torch.convert", save + "_fake", save + "_conv",
                             "--fuse_stages"]),
                ("main --load", ["-m", "qeft_tpu_torch.main", "--load", save + "_conv",
                                 "--eval", "--eval_windows", "2", "--benchmark", "32",
                                 "--eval_datasets", f"synthetic,{npy}", "--logfile", logfile])):
            tick = time.perf_counter()
            proc = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                                  cwd=root, timeout=600)
            lines = proc.stdout.strip().splitlines()
            log(f"[quantize-cli] python {' '.join(argv[:2])} ({QUANT_CLI_PRESET}) exit "
                f"{proc.returncode} in {time.perf_counter() - tick:.1f} s:")
            for line in [l for l in lines if "block" not in l][-5:]:
                log(f"    {line}")
            if proc.returncode != 0:
                log(proc.stderr[-3000:])
                raise AssertionError(f"{label} failed")
            out[label] = proc.stdout
        with open(logfile) as f:
            lines = [json.loads(line) for line in f]
    keys = {"model", "load", "eval_datasets", "logfile", "device", f"ppl_{npy}", "ppl_synthetic",
            "decode_tokens_per_s"}
    log(f"[quantize-cli] main --load --eval_datasets synthetic,<.npy> --logfile: {len(lines)} "
        f"line, keys {sorted(lines[0]) if lines else None}")
    if len(lines) != 1 or not keys <= set(lines[0]) or not all(
            np.isfinite(lines[0][k]) for k in ("ppl_synthetic", f"ppl_{npy}")):
        raise AssertionError("main --logfile did not write the run's line with its keys")
    fields = out["main"].split("fake-vs-packed delta ")
    delta = float(fields[1].split("%")[0]) / 100 if len(fields) == 2 else float("nan")
    if not delta < 1e-2:
        raise AssertionError(f"main's fake-vs-packed delta on {QUANT_CLI_PRESET}: {delta}")
    if "synthetic ppl" not in out["main --load"] or "decode:" not in out["main --load"]:
        raise AssertionError("main --load did not evaluate and benchmark the converted checkpoint")
    return dict(delta=delta)

def phase_family_train(cfg, params):
    """WCT of the other families: OPT-6.7B at full width and depth (the
    packed model of phase opt), TRAIN_STEPS steps with run_finetune's
    defaults and the training oracle (phase_family_train_oracle); then 2
    steps of Bloom-7b1 packed without the global reorder at FAMILY_LAYERS
    layers, so that the gradient of the ``reorder_ids`` gather runs on the
    card."""
    from qeft_tpu_torch.models.bloom import BLOOM_PRESETS
    from qeft_tpu_torch.testing import build_packed_model

    out = {"opt-6.7b": phase_train(cfg, params, "opt", "family-train opt-6.7b")}
    out["opt-6.7b oracle"] = phase_family_train_oracle(cfg, params, "opt", "family-train oracle")
    torch.cuda.empty_cache()
    bcfg = dataclasses.replace(BLOOM_PRESETS["bloom-7b1"], num_layers=FAMILY_LAYERS)
    bloom = build_packed_model(bcfg, seed=0, g=128, r=128, device="cuda", family="bloom",
                               reorder=False)
    out["bloom-7b1"] = phase_train(bcfg, bloom, "bloom", "family-train bloom-7b1 reorder_ids",
                                   steps=2)
    del bloom
    torch.cuda.empty_cache()
    return out


def _family_quantize_one(family, preset, n_layers, g, reorder):
    """One FAMILY_QUANT_RUNS entry: random bf16 weights at full width built
    on the card, OGR extraction and GPTQ-OWQ (w4, MSE grid, r = 128) with or
    without the global reorder on FAMILY_QUANT_SAMPLES synthetic crops of
    QUANT_SEQ tokens, packing, the packed checkpoint written and served; the
    oracle (recovered fake vs packed PPL within PPL_RTOL, the true fake
    delta printed), teacher-forced logits of the packed model against the
    fake one, and graph tokens equal to the eager loop's."""
    import importlib

    from qeft_tpu_torch import checkpoint as ckpt
    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.data import get_calibration_tokens, get_loaders
    from qeft_tpu_torch.eval import eval_ppl
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.main import load_for_serving
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.quant.quantizer import QuantSpec
    from qeft_tpu_torch.testing import dense_model

    module = importlib.import_module(f"qeft_tpu_torch.models.{family}")
    cfg = dataclasses.replace(getattr(module, f"{family.upper()}_PRESETS")[preset],
                              num_layers=n_layers)
    meta, api = get_model_meta(family), get_model_api(family)
    tag = f"family-quantize {preset}{'' if reorder else ' reorder_ids'}"
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense = module.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    calib = get_calibration_tokens("synthetic", FAMILY_QUANT_SAMPLES, 0, QUANT_SEQ,
                                   vocab_size=cfg.vocab_size)
    args = pl.QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=True, group_size=g),
                           target_rank=128, nsamples=FAMILY_QUANT_SAMPLES, no_frob_norm=True,
                           reorder=reorder, percdamp=1.0 if family == "falcon" else 0.01)
    log(f"[{tag}] random bf16 {preset} at {n_layers} layers (full width) on the card; "
        f"calibration {FAMILY_QUANT_SAMPLES} x {QUANT_SEQ} synthetic tokens; GPTQ-OWQ w4 g{g} MSE "
        f"r=128 percdamp {args.percdamp}, "
        + ("extraction, then the global reorder" if reorder else "per-linear weak columns"))
    outidx = None
    if reorder:
        with counted(f"{tag} extract") as c:
            tick = time.perf_counter()
            outidx, _ = pl.extract_global_outidx(dense, calib, cfg, meta, args)
            torch.cuda.synchronize()
            out["extract_s"] = time.perf_counter() - tick
        _expect(f"{tag} extraction (plain attention, no kernel)", c.counts, {})
    args.no_frob_norm = False
    with counted(f"{tag} calibration") as c:
        tick = time.perf_counter()
        fake, states = pl.quantize_model(dense, calib, cfg, meta, args, outidx)
        torch.cuda.synchronize()
        out["quantize_s"] = time.perf_counter() - tick
    _expect(f"{tag} GPTQ calibration", c.counts, {})
    out["quantize_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del dense
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "packed")
        tick = time.perf_counter()
        packed = pl.pack_model(fake, states, cfg, meta)
        torch.cuda.synchronize()
        out["pack_s"] = time.perf_counter() - tick
        ckpt.save_packed(path, packed, cfg, family=family)
        served, _, fam = load_for_serving(path, "cuda")
    if fam != family or not all(
            torch.equal(getattr(served["layers"][k], f), getattr(v, f))
            for k, v in packed["layers"].items() if hasattr(v, "qweight")
            for f in ("qweight", "scales", "scaled_zeros", "oweight")):
        raise AssertionError(f"{tag}: the packed checkpoint did not load back bit for bit")
    del packed
    log(f"[{tag}] extraction {out.get('extract_s', 0.0):.1f} s, quantization "
        f"{out['quantize_s']:.1f} s ({out['quantize_s'] / n_layers:.1f} s a block; each block's "
        f"seconds printed above), pack_model {out['pack_s']:.2f} s; peak device memory by the "
        f"end of the quantization {out['quantize_peak_gb']:.3f} GB")

    test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
    windows, n_lin = QUANT_EVAL_WINDOWS, len(meta.all_linears) * n_layers
    recovered = dense_model(served)
    ppl = {}
    for label, params, want in (("fake", fake, {}), ("recovered fake", recovered, {}),
                                ("packed", served, {"qgemm": n_lin * windows})):
        with counted(f"{tag} eval {label}") as c:
            ppl[label] = eval_ppl(params, test, cfg, seqlen=QUANT_SEQ, max_windows=windows,
                                  api=api, device="cuda")
        _expect(f"{tag} eval of the {label} model", c.counts, want)
    del recovered
    delta = abs(ppl["packed"] - ppl["recovered fake"]) / ppl["recovered fake"]
    fake_delta = abs(ppl["packed"] - ppl["fake"]) / ppl["fake"]
    out.update(ppl_fake=ppl["fake"], ppl_recovered=ppl["recovered fake"],
               ppl_packed=ppl["packed"], ppl_delta=delta, ppl_delta_fake=fake_delta)
    log(f"[{tag}] synthetic ppl ({windows} windows of {QUANT_SEQ}): fake {ppl['fake']:.4f}, "
        f"recovered fake {ppl['recovered fake']:.4f}, packed {ppl['packed']:.4f}; "
        f"recovered-fake-vs-packed delta {delta:.4%} (bound {PPL_RTOL:.2%}), fake-vs-packed "
        f"delta {fake_delta:.4%} (printed)")
    if not (np.isfinite(ppl["fake"]) and np.isfinite(ppl["packed"]) and delta <= PPL_RTOL):
        raise AssertionError(f"{tag}: the packed model's PPL disagrees with its fake model's")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device="cuda")

    def run(graph):
        cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")
        return generate(served, prompt, cache, cfg, FAMILY_QUANT_NEW, api=api, device="cuda",
                        graph=graph)[0]

    run(True)  # warm-up: the capture
    with counted(f"{tag} generate") as c:
        tick = time.perf_counter()
        got = run(True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    _expect(f"{tag} generate from the packed checkpoint", c.counts,
            {"qgemv": n_lin * (FAMILY_QUANT_NEW - 1), "qgemm": n_lin,
             **_decode_attention_launches(family, cfg, FAMILY_QUANT_NEW - 1)})
    eager = run(False)
    same = bool(torch.equal(got, eager))
    log(f"[{tag}] generate: {PROMPT} + {FAMILY_QUANT_NEW} tokens in {dt:.3f} s through the graph; "
        f"tokens equal to the eager loop's: {same}")
    if not same or not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: graph tokens differ from the eager loop's")
    lp = _teacher_forced(served, cfg, api, prompt, got)
    lf = _teacher_forced(fake, cfg, api, prompt, got)
    diff, scale = (lp - lf).abs().amax(dim=-1), lf.abs().amax().item()
    out.update(max_logit_diff=diff.max().item(), logit_scale=scale,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{tag}] teacher-forced logits, packed vs fake: max |diff| {out['max_logit_diff']:.4g}, "
        f"fake logit scale {scale:.4g}, bound {ORACLE_RTOL * scale:.4g}; argmax agreement "
        f"{(lp.argmax(-1) == lf.argmax(-1)).sum().item()}/{FAMILY_QUANT_NEW}; peak device "
        f"memory {out['peak_memory_gb']:.3f} GB")
    if not (torch.isfinite(lp).all() and out["max_logit_diff"] <= ORACLE_RTOL * scale):
        raise AssertionError(f"{tag}: the packed model's logits disagree with the fake model's")
    del served, fake
    torch.cuda.empty_cache()
    return out


def phase_family_quantize():
    """QEFT's quantizer on OPT-6.7B, Phi-2, Bloom-7b1 (with and without the
    global reorder) and Falcon-7b at full width (FAMILY_QUANT_RUNS)."""
    return {f"{preset}{'' if reorder else ' reorder_ids'}": _family_quantize_one(
        family, preset, n_layers, g, reorder)
        for family, preset, n_layers, g, reorder in FAMILY_QUANT_RUNS}


def phase_hf():
    """A Hugging Face directory of OPT-6.7B at full width and HF_LAYERS
    layers, written from the preset's random bf16 tree in two shards with an
    index (``testing.write_hf_opt``); ``load_hf_model`` gives the tree
    written, bit for bit; then ``extract_outidx --model <dir>`` and ``main
    --model <dir> --reorder --packing --eval`` as subprocesses, in a thread
    beside the next phase (`_hf_cli`, returned running)."""
    from qeft_tpu_torch.checkpoint import to_flat
    from qeft_tpu_torch.models.hf_loader import load_hf_model
    from qeft_tpu_torch.models.opt import OPT_PRESETS, init_params
    from qeft_tpu_torch.testing import write_hf_opt

    cfg = dataclasses.replace(OPT_PRESETS["opt-6.7b"], num_layers=HF_LAYERS)
    out = {}
    tmp = tempfile.mkdtemp()
    try:
        hf = os.path.join(tmp, "opt-6.7b-hf")
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        tick = time.perf_counter()
        write_hf_opt(hf, params, cfg, shards=2)
        out["write_s"] = time.perf_counter() - tick
        tick = time.perf_counter()
        loaded, lcfg, family = load_hf_model(hf, device="cuda")
        torch.cuda.synchronize()
        out["read_s"] = time.perf_counter() - tick
        want, got = to_flat(params), to_flat(loaded)
        same = (family == "opt" and lcfg == cfg and sorted(want) == sorted(got)
                and all(np.array_equal(got[k], v) for k, v in want.items()))
        size = sum(os.path.getsize(os.path.join(hf, f)) for f in os.listdir(hf))
        log(f"[hf] opt-6.7b at {HF_LAYERS} layers written as an HF directory ({size} bytes, "
            f"2 shards) in {out['write_s']:.1f} s, read back in {out['read_s']:.1f} s: the tree "
            f"equal bit for bit: {same}")
        if not same:
            raise AssertionError("load_hf_model did not read back the tree written")
        del params, loaded, want, got
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(tmp)
        raise
    return _Beside(_hf_cli, tmp, hf)


def _hf_cli(tmp, hf):
    """``extract_outidx`` and ``main --model <dir>`` on the HF directory
    ``hf`` as subprocesses (subprocesses only: run beside the next phase);
    removes ``tmp`` after."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    try:
        common = ["--model", hf, "--wbits", "4", "--target_rank", "128", "--groupsize", "128",
                  "--nsamples", "8", "--seqlen", "2048"]
        oidx = os.path.join(tmp, "oidx")
        for label, argv in (
                ("extract_outidx", ["-m", "qeft_tpu_torch.extract_outidx", *common,
                                    "--no_frob_norm", "--output_dir", oidx]),
                ("main", ["-m", "qeft_tpu_torch.main", *common, "--reorder", "--outidx_file",
                          os.path.join(oidx, "w4_r128", "outidx.npy"), "--packing", "--save",
                          os.path.join(tmp, "q"), "--eval", "--eval_windows", "1"])):
            tick = time.perf_counter()
            proc = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                                  cwd=root, timeout=600)
            log(f"[hf] python {' '.join(argv[:2])} --model <HF dir> exit {proc.returncode} in "
                f"{time.perf_counter() - tick:.1f} s:")
            for line in [l for l in proc.stdout.strip().splitlines() if "block" not in l][-4:]:
                log(f"    {line}")
            if proc.returncode != 0:
                log(proc.stderr[-3000:])
                raise AssertionError(f"{label} --model <HF dir> failed")
            out[label] = proc.stdout
    finally:
        shutil.rmtree(tmp)
    fields = out["main"].split("fake-vs-packed delta ")
    delta = float(fields[1].split("%")[0]) / 100 if len(fields) == 2 else float("nan")
    if not delta < 1e-2:
        raise AssertionError(f"main --model <HF dir>: fake-vs-packed delta {delta}")
    return dict(delta=delta)


# ---------------------------------------------------------------------------
# models larger than the card, and the reference's checkpoints


class _Tee:
    """stdout echoed as it comes and its lines kept (the pipeline prints
    each block's seconds and peak device memory)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def blocks(self, kind):
        """[(seconds, peak GB)] of the ``kind`` ("extract", "quantize") block lines."""
        import re

        pat = re.compile(rf"^{kind}: block \d+/\d+ in ([0-9.]+) s, peak ([0-9.]+) GB")
        return [(float(m.group(1)), float(m.group(2))) for m in
                (pat.match(line) for line in "".join(self.text).splitlines()) if m]


def _blocks_hold_their_peak(tag, kind, blocks):
    """Each block's seconds and peak; a later block's peak more than
    STREAM_PEAK_GROWTH over the first's fails (a path that kept earlier
    blocks on the card would grow with depth)."""
    log(f"[{tag}] {kind} blocks (seconds, peak device GB): {blocks}")
    if not blocks or any(peak > (1 + STREAM_PEAK_GROWTH) * blocks[0][1] for _, peak in blocks):
        raise AssertionError(f"{tag}: a later {kind} block's device peak exceeds the first's "
                             f"by more than {STREAM_PEAK_GROWTH:.0%}: {blocks}")


def _on_card(tree):
    from qeft_tpu_torch.checkpoint import tree_map

    return tree_map(lambda t: t.to("cuda"), tree)


def _stream_quantize(tag, tree, calib, cfg, meta, args, device, k3_per_block):
    """Extraction, GPTQ-OWQ with the global reorder (the column blocks
    captured) and packing (stages fused) of ``tree`` with the blocks on
    ``device`` (None: where the tree lives), K3 counted in every
    calibration forward; -> (outidx, fake, states, packed, seconds, tee)."""
    from qeft_tpu_torch import pipeline as pl

    n = cfg.num_layers
    out, tee = {}, _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        with counted(f"{tag} extract") as c:
            tick = time.perf_counter()
            outidx, _ = pl.extract_global_outidx(tree, calib, cfg, meta,
                                                 dataclasses.replace(args, no_frob_norm=True),
                                                 device=device)
            torch.cuda.synchronize()
            out["extract_s"] = time.perf_counter() - tick
        _expect(f"{tag} extraction", c.counts, {"flash_window_attention": n * k3_per_block})
        with counted(f"{tag} calibration") as c:
            tick = time.perf_counter()
            fake, states = pl.quantize_model(tree, calib, cfg, meta, args, outidx, device=device)
            torch.cuda.synchronize()
            out["quantize_s"] = time.perf_counter() - tick
        _expect(f"{tag} GPTQ calibration", c.counts,
                {"flash_window_attention": 2 * n * k3_per_block})
        tick = time.perf_counter()
        packed = pl.pack_model(fake, states, cfg, meta, fuse_stages=True, device=device)
        torch.cuda.synchronize()
        out["pack_s"] = time.perf_counter() - tick
    log(f"[{tag}] extraction {out['extract_s']:.1f} s, quantization {out['quantize_s']:.1f} s "
        f"({out['quantize_s'] / n:.2f} s a block), pack_model {out['pack_s']:.2f} s")
    return outidx, fake, states, packed, out, tee


def phase_stream_equal():
    """stream (a): one random f32 tree of Llama-2-7B width at STREAM_A_LAYERS
    layers (``host_init_params``) quantized twice -- held in host memory
    with its blocks streamed to the card, and copied to the card and
    quantized there -- bit-identical: the weak set, the fake trees, every
    quantizer state (scales, zeros, weak ids), the packed codes, scales and
    slabs, and byte-equal packed checkpoints; then ``eval_ppl_streamed`` of
    the host fake tree within 1e-4 relative of ``eval_ppl`` of the card's."""
    from qeft_tpu_torch import checkpoint as ckpt
    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.data import get_calibration_tokens, get_loaders
    from qeft_tpu_torch.eval import eval_ppl, eval_ppl_streamed
    from qeft_tpu_torch.extract_outidx import host_init_params, tree_bytes
    from qeft_tpu_torch.main import _eval_api
    from qeft_tpu_torch.models import llama
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.quant.quantizer import QuantSpec

    tag = "stream-equal"
    cfg = dataclasses.replace(llama.LLAMA_PRESETS[QUANT_PRESET], num_layers=STREAM_A_LAYERS)
    meta = get_model_meta("llama")
    tick = time.perf_counter()
    host = host_init_params(llama, cfg, 0, torch.float32)
    init_s = time.perf_counter() - tick
    card = _on_card(host)
    calib = get_calibration_tokens("synthetic", STREAM_A_SAMPLES, 0, QUANT_SEQ,
                                   vocab_size=cfg.vocab_size)
    args = pl.QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=True, group_size=128),
                           target_rank=128, nsamples=STREAM_A_SAMPLES)
    log(f"[{tag}] random f32 {QUANT_PRESET} at {STREAM_A_LAYERS} layers (full width), drawn in "
        f"host memory in {init_s:.1f} s ({tree_bytes(host) / 1e9:.2f} GB) and copied to the card; "
        f"calibration {STREAM_A_SAMPLES} x {QUANT_SEQ}; w4 g128 MSE r=128, the global reorder")
    runs = {}
    for label, tree, device in (("streamed", host, "cuda"), ("resident", card, None)):
        runs[label] = _stream_quantize(f"{tag} {label}", tree, calib, cfg, meta, args, device,
                                       STREAM_A_SAMPLES)
    (o_s, f_s, s_s, p_s, t_s, _), (o_r, f_r, s_r, p_r, t_r, _) = (runs["streamed"],
                                                                  runs["resident"])
    same = {"outidx": bool(np.array_equal(o_s, o_r))}
    fs, fr = ckpt.to_flat(f_s), ckpt.to_flat(f_r)
    same["fake trees"] = sorted(fs) == sorted(fr) and all(np.array_equal(fs[k], fr[k]) for k in fr)
    same["states"] = sorted(s_s) == sorted(s_r) and all(
        torch.equal(getattr(s_s[k], f), getattr(v, f).cpu()) for k, v in s_r.items()
        for f in ("scale_group", "zero_group", "out_ids"))
    for field in ("qweight", "scales", "scaled_zeros", "oweight"):
        same[field] = all(torch.equal(getattr(p_s["layers"][k], field),
                                      getattr(v, field).cpu())
                          for k, v in p_r["layers"].items() if hasattr(v, "qweight"))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in ("streamed", "resident")}
        ckpt.save_packed(paths["streamed"], p_s, cfg)
        ckpt.save_packed(paths["resident"], p_r, cfg)
        blobs = [open(paths[k] + ".npz", "rb").read() for k in ("streamed", "resident")]
        same["packed checkpoints, byte for byte"] = blobs[0] == blobs[1]
        size = len(blobs[0])
    del blobs, card, p_s, p_r
    log(f"[{tag}] streamed vs resident, bit for bit: {same} (checkpoint {size} bytes)")
    if not all(same.values()):
        raise AssertionError(f"{tag}: the streamed quantization differs from the resident one")

    test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
    windows = QUANT_EVAL_WINDOWS
    with counted(f"{tag} eval_ppl_streamed") as c:
        tick = time.perf_counter()
        ppl_s = eval_ppl_streamed(f_s, test, cfg, meta, seqlen=QUANT_SEQ, max_windows=windows,
                                  device="cuda")
        streamed_s = time.perf_counter() - tick
    _expect(f"{tag} eval_ppl_streamed", c.counts,
            {"flash_window_attention": STREAM_A_LAYERS * windows})
    fused = pl.fuse_dense_stages(f_r, meta)
    ppl_r = eval_ppl(fused, test, cfg, seqlen=QUANT_SEQ, max_windows=windows,
                     api=_eval_api(fused, "llama"), device="cuda")
    rel = abs(ppl_s - ppl_r) / ppl_r
    log(f"[{tag}] eval_ppl_streamed of the host fake tree {ppl_s:.6f} ({streamed_s:.1f} s) vs "
        f"eval_ppl of the card's {ppl_r:.6f}: relative {rel:.3g} (bound {STREAM_EVAL_RTOL:g})")
    if not (np.isfinite(ppl_s) and rel <= STREAM_EVAL_RTOL):
        raise AssertionError(f"{tag}: eval_ppl_streamed disagrees with eval_ppl")
    del fused, f_r, f_s
    torch.cuda.empty_cache()
    return dict(streamed=t_s, resident=t_r, ppl_streamed=ppl_s, ppl=ppl_r, eval_rel=rel,
                init_s=init_s)


def phase_stream_70b():
    """stream (b): ``llama2-70b`` at full width (hidden 8192, 64 query and 8
    kv heads, ffn 28,672) and STREAM_B_LAYERS layers, a random f32 tree held
    in host memory: extraction, GPTQ-OWQ with the captured column loop,
    ``reorder_model_host`` and the streamed ``pack_model``, one block on the
    card at a time on QUANT_SAMPLES x QUANT_SEQ calibration crops, each
    block's seconds and peak device memory (a later block's peak above the
    first's by more than STREAM_PEAK_GROWTH fails); then the packed model
    served through K1-K4 (``generate`` 64 + STREAM_NEW through the graph,
    tokens equal to the eager loop's, launches counted: GQA 64 / 8); the
    reference's oracle (recovered fake vs packed PPL within PPL_RTOL, the
    true fake delta printed); and ``eval_ppl_streamed`` of the host fake
    tree against ``eval_ppl`` of it on the card."""
    from qeft_tpu_torch import pipeline as pl
    from qeft_tpu_torch.data import get_calibration_tokens, get_loaders
    from qeft_tpu_torch.eval import eval_ppl, eval_ppl_streamed
    from qeft_tpu_torch.extract_outidx import host_init_params, tree_bytes
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.main import _eval_api
    from qeft_tpu_torch.models import llama
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.quant.quantizer import QuantSpec
    from qeft_tpu_torch.testing import dense_model

    tag = "stream-70b"
    cfg = dataclasses.replace(llama.LLAMA_PRESETS["llama2-70b"], num_layers=STREAM_B_LAYERS)
    meta, api, n = get_model_meta("llama"), get_model_api("llama"), STREAM_B_LAYERS
    tick = time.perf_counter()
    host = host_init_params(llama, cfg, 0, torch.float32)
    out = {"init_s": time.perf_counter() - tick, "host_gb": tree_bytes(host) / 1e9}
    calib = get_calibration_tokens("synthetic", QUANT_SAMPLES, 0, QUANT_SEQ,
                                   vocab_size=cfg.vocab_size)
    args = pl.QuantizeArgs(spec=QuantSpec(bits=4, sym=False, mse=True, group_size=128),
                           target_rank=128, nsamples=QUANT_SAMPLES)
    log(f"[{tag}] random f32 llama2-70b at {n} layers (full width: hidden 8192, 64/8 heads, "
        f"ffn 28672) in host memory: {out['host_gb']:.2f} GB drawn in {out['init_s']:.1f} s; "
        f"calibration {QUANT_SAMPLES} x {QUANT_SEQ}; w4 g128 MSE r=128, the global reorder")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, fake, states, packed, t, tee = _stream_quantize(tag, host, calib, cfg, meta, args, "cuda",
                                                       QUANT_SAMPLES)
    out.update(t)
    del host
    for kind in ("extract", "quantize"):
        out[f"{kind}_blocks"] = tee.blocks(kind)
        _blocks_hold_their_peak(tag, kind, out[f"{kind}_blocks"])
    if fake["embed"].device.type != "cpu" or packed["embed"].device.type != "cpu":
        raise AssertionError(f"{tag}: the streamed fake and packed trees should be on the host")

    served = pl.fuse_packed_stages(_on_card(packed), meta)
    del packed
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device="cuda")
    steps = STREAM_NEW - 1

    def run(graph):
        cache = api.init_cache(cfg, 1, PROMPT + STREAM_NEW, dtype=torch.bfloat16, device="cuda")
        return generate(served, prompt, cache, cfg, STREAM_NEW, api=api, device="cuda",
                        graph=graph)[0]

    run(True)  # warm-up: the capture
    with counted(f"{tag} generate") as c:
        tick = time.perf_counter()
        got = run(True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    _expect(f"{tag} generate from the packed model", c.counts,
            {"qgemv_stacked_fused": 4 * n * steps, "decode_attention": n * steps,
             "qgemm": 4 * n, "flash_window_attention": n})
    eager = run(False)
    same = bool(torch.equal(got, eager))
    log(f"[{tag}] generate: {PROMPT} + {STREAM_NEW} tokens in {dt:.3f} s through the graph "
        f"({STREAM_NEW / dt:.2f} tok/s); tokens equal to the eager loop's: {same}")
    if not same or not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: graph tokens differ from the eager loop's")

    test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
    windows = QUANT_EVAL_WINDOWS
    ppl = {}
    with counted(f"{tag} eval_ppl_streamed") as c:
        tick = time.perf_counter()
        ppl["fake, streamed"] = eval_ppl_streamed(fake, test, cfg, meta, seqlen=QUANT_SEQ,
                                                  max_windows=windows, device="cuda")
        out["eval_streamed_s"] = time.perf_counter() - tick
    _expect(f"{tag} eval_ppl_streamed", c.counts, {"flash_window_attention": n * windows})
    fused = pl.fuse_dense_stages(_on_card(fake), meta)
    del fake
    recovered = dense_model(served)
    for label, params, want in (
            ("fake", fused, {"flash_window_attention": n * windows}),
            ("recovered fake", recovered, {"flash_window_attention": n * windows}),
            ("packed", served, {"qgemm": 4 * n * windows, "flash_window_attention": n * windows})):
        with counted(f"{tag} eval {label}") as c:
            ppl[label] = eval_ppl(params, test, cfg, seqlen=QUANT_SEQ, max_windows=windows,
                                  api=_eval_api(params, "llama"), device="cuda")
        _expect(f"{tag} eval of the {label} model", c.counts, want)
    del fused, recovered, served
    torch.cuda.empty_cache()
    delta = abs(ppl["packed"] - ppl["recovered fake"]) / ppl["recovered fake"]
    fake_delta = abs(ppl["packed"] - ppl["fake"]) / ppl["fake"]
    rel = abs(ppl["fake, streamed"] - ppl["fake"]) / ppl["fake"]
    out.update(ppl=ppl, ppl_delta=delta, ppl_delta_fake=fake_delta, eval_rel=rel,
               generate_s=dt, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{tag}] synthetic ppl ({windows} windows of {QUANT_SEQ}): "
        + ", ".join(f"{k} {v:.6f}" for k, v in ppl.items())
        + f"; recovered-fake-vs-packed delta {delta:.4%} (bound {PPL_RTOL:.2%}), fake-vs-packed "
        f"delta {fake_delta:.4%} (printed); eval_ppl_streamed vs eval_ppl of the fake tree: "
        f"relative {rel:.3g} (bound {STREAM_EVAL_RTOL:g}) in {out['eval_streamed_s']:.1f} s; "
        f"peak device memory since the last block {out['peak_memory_gb']:.3f} GB")
    if not (all(np.isfinite(v) for v in ppl.values()) and delta <= PPL_RTOL
            and rel <= STREAM_EVAL_RTOL):
        raise AssertionError(f"{tag}: the oracle or the streamed eval failed")
    return out


def _llama_config_dir(path, cfg):
    """A Hugging Face ``config.json`` for ``cfg`` (the config the importer's
    ``--model <dir>`` reads)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta}, f)


def phase_import(cfg, params):
    """import: the random packed Llama-2-7B (its first IMPORT_LAYERS layers,
    full width) written as a reference (xvyaward/qeft) packed checkpoint
    with ``torch.save`` (``testing.write_reference_packed``), then imported
    on the card: codes and ``o_reorder`` bit-exact, scales, zero points,
    slabs, norms, embedding and head bit-exact wherever their bf16 value is
    exact in fp16 (checked and counted); ``generate`` 64 + 64 through the
    graph from the imported model, greedy tokens equal to the source's;
    a WCT overlay (``write_reference_wct``) lands on its slabs; the
    ``import_reference`` CLI (``--model`` a config directory) writes the
    checkpoint the library does, and ``main --load ... --eval`` evaluates it
    to the in-process PPL."""
    from qeft_tpu_torch.data import get_loaders
    from qeft_tpu_torch.eval import eval_ppl
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.import_reference import import_reference_packed, import_reference_wct
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.registry import get_model_meta
    from qeft_tpu_torch.ops.packing import QLinearParams
    from qeft_tpu_torch.pipeline import fuse_packed_stages
    from qeft_tpu_torch.testing import write_reference_packed, write_reference_wct

    tag, n = "import", IMPORT_LAYERS
    small = dataclasses.replace(cfg, num_layers=n)
    meta, api = get_model_meta("llama"), get_model_api("llama")
    src = {**params, "layers": {k: (v.map(lambda t: t[:n]) if isinstance(v, QLinearParams)
                                    else v[:n]) for k, v in params["layers"].items()}}
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref_packed.pth")
        tick = time.perf_counter()
        ckpt = write_reference_packed(src, small)
        torch.save(ckpt, ref)
        out["write_s"] = time.perf_counter() - tick
        tick = time.perf_counter()
        got, _ = import_reference_packed(ref, small, device="cuda")
        torch.cuda.synchronize()
        out["import_s"] = time.perf_counter() - tick
        got = fuse_packed_stages(got, meta)
        exact = {"codes": 0, "o_reorder": 0}
        inexact = total = 0
        for name, want in src["layers"].items():
            have = got["layers"][name]
            if isinstance(want, QLinearParams):
                exact["codes"] += int(not torch.equal(have.qweight, want.qweight))
                pairs = [(getattr(have, f), getattr(want, f))
                         for f in ("scales", "scaled_zeros", "oweight")]
            elif name == "o_reorder":
                exact["o_reorder"] += int(not torch.equal(have, want))
                pairs = []
            else:
                pairs = [(have, want)]
            for h, w in pairs:
                ok = w.to(torch.float16).to(w.dtype) == w
                inexact += int((~ok).sum())
                total += w.numel()
                if not torch.equal(h[ok], w[ok]):
                    raise AssertionError(f"{tag}: {name} differs where fp16 holds its value")
        for key in ("embed", "final_ln", "lm_head"):
            w = src[key]
            ok = w.to(torch.float16).to(w.dtype) == w
            inexact += int((~ok).sum())
            total += w.numel()
            if not torch.equal(got[key][ok], w[ok]):
                raise AssertionError(f"{tag}: {key} differs where fp16 holds its value")
        log(f"[{tag}] {n} layers of the random packed {QUANT_PRESET} written as a reference "
            f"checkpoint ({os.path.getsize(ref)} bytes) in {out['write_s']:.1f} s, imported on "
            f"the card in {out['import_s']:.1f} s: linears whose codes differ {exact['codes']}, "
            f"o_reorder {exact['o_reorder']}; float values bit-exact wherever fp16 holds them, "
            f"{inexact} of {total} ({inexact / total:.3g}) not exact in fp16 (subnormal there)")
        if any(exact.values()):
            raise AssertionError(f"{tag}: the imported codes differ from the source's")

        prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                               generator=torch.Generator(device="cuda").manual_seed(3),
                               device="cuda")
        steps = IMPORT_NEW - 1
        tokens = {}
        for label, tree in (("source", src), ("imported", got)):
            cache = api.init_cache(small, 1, PROMPT + IMPORT_NEW, dtype=torch.bfloat16,
                                   device="cuda")
            generate(tree, prompt, cache, small, IMPORT_NEW, api=api, device="cuda")  # capture
            cache = api.init_cache(small, 1, PROMPT + IMPORT_NEW, dtype=torch.bfloat16,
                                   device="cuda")
            with counted(f"{tag} generate {label}") as c:
                tokens[label] = generate(tree, prompt, cache, small, IMPORT_NEW, api=api,
                                         device="cuda")[0]
            _expect(f"{tag} generate from the {label} model", c.counts,
                    {"qgemv_stacked_fused": 4 * n * steps, "decode_attention": n * steps,
                     "qgemm": 4 * n, "flash_window_attention": n})
        same = bool(torch.equal(tokens["source"], tokens["imported"]))
        log(f"[{tag}] generate {PROMPT} + {IMPORT_NEW} through the graph: the imported model's "
            f"greedy tokens equal the source's: {same}")
        if not same:
            raise AssertionError(f"{tag}: the imported model generates other tokens")

        hd = cfg.num_heads * cfg.head_dim
        g = torch.Generator(device="cuda").manual_seed(4)
        slabs = {(1, "q"): torch.randn(128, hd, generator=g, device="cuda") * 0.02,
                 (n - 1, "down"): torch.randn(128, cfg.hidden_size, generator=g,
                                              device="cuda") * 0.02}
        wct = os.path.join(tmp, "wct.pth")
        torch.save(write_reference_wct(slabs, ref), wct)
        tuned, _ = import_reference_wct(wct, small, device="cuda")
        landed = all(torch.equal(tuned["layers"][name].oweight[i],
                                 w.to(torch.float16).to(torch.bfloat16))
                     for (i, name), w in slabs.items())
        kept = torch.equal(tuned["layers"]["q"].oweight[0],
                           got["layers"]["qkv"].oweight[0][:, :hd])
        log(f"[{tag}] WCT overlay: the tuned slabs landed on layer 1 q and layer {n - 1} down: "
            f"{landed}; layer 0's q slab kept: {kept}")
        if not (landed and kept):
            raise AssertionError(f"{tag}: the WCT overlay did not land on its slabs")
        del tuned

        cfg_dir, dst = os.path.join(tmp, "config"), os.path.join(tmp, "imported")
        _llama_config_dir(cfg_dir, small)
        test = get_loaders("synthetic", train=False, vocab_size=cfg.vocab_size)
        want = eval_ppl(got, test, small, seqlen=QUANT_SEQ, max_windows=1, api=api,
                        device="cuda")
        for label, argv in (
                ("import_reference", ["-m", "qeft_tpu_torch.import_reference", ref, dst,
                                      "--model", cfg_dir]),
                ("main --load", ["-m", "qeft_tpu_torch.main", "--load", dst, "--eval",
                                 "--eval_windows", "1", "--seqlen", str(QUANT_SEQ)])):
            tick = time.perf_counter()
            proc = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                                  cwd=root, timeout=600)
            log(f"[{tag}] python {' '.join(argv[:2])} exit {proc.returncode} in "
                f"{time.perf_counter() - tick:.1f} s:")
            for line in proc.stdout.strip().splitlines()[-3:]:
                log(f"    {line}")
            if proc.returncode != 0:
                log(proc.stderr[-3000:])
                raise AssertionError(f"{tag}: {label} failed")
            out[label] = proc.stdout
        fields = out["main --load"].split("synthetic ppl: ")
        ppl = float(fields[1].split()[0]) if len(fields) == 2 else float("nan")
        log(f"[{tag}] main --load of the CLI's checkpoint: ppl {ppl:.4f}; in process {want:.4f}")
        if not abs(ppl - want) <= 1e-4 * want:
            raise AssertionError(f"{tag}: main --load of the imported checkpoint: ppl {ppl}, "
                                 f"expected {want}")
    del got, src
    torch.cuda.empty_cache()
    return dict(write_s=out["write_s"], import_s=out["import_s"], ppl=want, inexact=inexact)


# ---------------------------------------------------------------------------
# parallel serving: ranks that share the card, each its own process, their
# collectives over Gloo through pinned host memory (NCCL refuses two ranks
# on one device), so collective time is host-staged and no speed result


def _rank_part(out, name, fn):
    """``fn()`` as main path ``name`` of this rank: the launch counts set to
    0 just before it and read just after, with its host-clock seconds."""
    from qeft_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    tick = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - tick
    res["launches"] = dict(cuda_lib.launches)
    out[name] = res


def _collective_ms(mesh, axis, rank):
    """Milliseconds of one host-staged psum of a [1, 4096] bf16 row over
    ``axis`` (GLOO_PROBES of them after a warm-up), as each tp stage
    pays it."""
    x = torch.ones(1, 4096, dtype=torch.bfloat16, device=mesh.device)
    for _ in range(5):
        mesh.psum(x, axis)
    torch.cuda.synchronize()
    tick = time.perf_counter()
    for _ in range(GLOO_PROBES):
        mesh.psum(x, axis)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - tick) * 1e3 / GLOO_PROBES
    log(f"[parallel rank {rank}] one psum of 8 KiB over {axis} ({mesh.shape[axis]} ranks): "
        f"{ms:.3f} ms (Gloo through pinned host memory)")
    return ms


def _rank_step_profile(label, step, rank, n=4):
    """Host clock and device busy time of a decode step on this rank (the
    profiler's kernels; the staging copies of the collectives apart)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    tick = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - tick) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels, _ = kernel_times(prof, n)
    copies = sum(ms for name, ms in kernels if name.startswith("Memcpy"))
    busy = sum(ms for name, ms in kernels if not name.startswith("Memcpy"))
    log(f"[parallel rank {rank}] {label} decode step: host clock {wall:.3f} ms, device busy "
        f"{busy:.3f} ms in kernels (+ {copies:.3f} ms of staging copies); the collectives are "
        "host-staged Gloo on one card, not a speed result")
    return dict(wall_ms=wall, busy_ms=busy, copy_ms=copies)


def _parallel_rank(cfg, prompt, prompts, long_prompt, started):
    """One of the two ranks of phase ``parallel``: the Llama-2-7B of phase
    model (seed 0) built on the card; tp_generate at tp 2 over bf16 and int8
    caches, Engine(mesh) at tp 2, pp_generate at pp 2, the sp prefill and
    decode at sp 2, and MultiHostEngine over the two ranks as dp replicas.
    Host values only come back."""
    import torch.distributed as dist

    from qeft_tpu_torch.models.llama import init_kv_cache
    from qeft_tpu_torch.parallel.mesh import make_mesh, shard_tree
    from qeft_tpu_torch.parallel.pp import pp_generate
    from qeft_tpu_torch.parallel.sp import llama_decode_step_sp, llama_prefill_sp
    from qeft_tpu_torch.parallel.tp_forward import (
        _local_cfg,
        tp_decode_step,
        tp_generate,
        tp_shard_packed_params,
    )
    from qeft_tpu_torch.serving import Engine, MultiHostEngine, Request
    from qeft_tpu_torch.testing import build_packed_model

    rank = dist.get_rank()
    mesh = make_mesh((1, 2), ("dp", "tp"))
    dev = mesh.device
    params = build_packed_model(cfg, seed=0, g=128, r=128, device=dev)
    sharded = tp_shard_packed_params(params, mesh, cfg)
    lcfg = _local_cfg(cfg, 2)
    prompt = torch.as_tensor(prompt, device=dev)
    out = {"ready_s": time.time() - started, "psum_ms": _collective_ms(mesh, "tp", rank)}
    for label, quantized in (("tp bf16", False), ("tp int8", True)):
        def new_cache():
            return init_kv_cache(lcfg, 1, CACHE, device=dev, quantized=quantized)

        tp_generate(sharded, prompt, new_cache(), cfg, mesh, 4)  # warm-up

        def gen():
            toks, _, logits = tp_generate(sharded, prompt, new_cache(), cfg, mesh, PAR_NEW,
                                          return_logits=True)
            return dict(tokens=toks.cpu(), logits=logits[0].cpu())

        _rank_part(out, label, gen)
    cache = init_kv_cache(lcfg, 1, CACHE, device=dev)
    tok = prompt[:, :1]
    tp_generate(sharded, prompt, cache, cfg, mesh, 1)
    with torch.inference_mode():
        out["tp bf16"]["step"] = _rank_step_profile(
            "tp bf16", lambda: tp_decode_step(sharded, tok, cache, PROMPT, cfg, mesh), rank)
    del cache

    def serve(engine, gen):
        for i, p in enumerate(prompts):
            engine.submit(Request(request_id=i, prompt=np.asarray(p), max_new_tokens=gen))
        done = engine.run()
        return {r.request_id: list(r.output) for r in done}

    eng = Engine(sharded, cfg, mesh=mesh, max_batch=ENGINE_SLOTS,
                 max_len=ENGINE_CTX + TP_ENGINE_GEN + 1, burst=16)
    _rank_part(out, "tp engine", lambda: dict(outputs=serve(eng, TP_ENGINE_GEN), ticks=eng.ticks))
    del sharded, eng
    torch.cuda.empty_cache()

    pp_mesh = make_mesh((2,), ("pp",))
    batch = torch.as_tensor(np.stack(prompts[:PP_BATCH]), device=dev)
    _rank_part(out, "pp", lambda: dict(tokens=pp_generate(
        params, batch, init_kv_cache(cfg, PP_BATCH, CACHE, device=dev), cfg, pp_mesh, PAR_NEW,
        n_microbatches=PP_MICRO).cpu()))

    sp_mesh = make_mesh((2,), ("sp",))
    long_prompt = torch.as_tensor(long_prompt, device=dev)

    def sp():
        logits, kv = llama_prefill_sp(params, long_prompt, cfg, sp_mesh)
        s_max = SP_SEQ + SP_DECODE
        cache = init_kv_cache(cfg, 1, s_max, device=dev)
        for k in cache:
            cache[k][:, :, :, :SP_SEQ] = kv[k]
        del kv
        local = shard_tree(cache, {k: (None, None, None, "sp") for k in cache}, sp_mesh)
        del cache
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        res = dict(prefill_rows=logits[0, ::SP_ROW_STRIDE].float().cpu(),
                   prefill_argmax=logits[0].argmax(-1).cpu(), tokens=[], logits=[])
        del logits
        for i in range(SP_DECODE):
            res["tokens"].append(int(tok))
            lg, local = llama_decode_step_sp(params, tok, local, SP_SEQ + i, cfg, sp_mesh)
            res["logits"].append(lg[0].float().cpu())
            tok = torch.argmax(lg, dim=-1)[:, None]
        res["logits"] = torch.stack(res["logits"])
        return res

    _rank_part(out, "sp", sp)
    torch.cuda.empty_cache()

    dp_mesh = make_mesh((2, 1), ("dp", "tp"))
    mh = MultiHostEngine(params, cfg, mesh=dp_mesh, max_batch=ENGINE_SLOTS,
                         max_len=ENGINE_CTX + ENGINE_GEN + 1, burst=16)
    _rank_part(out, "multihost", lambda: dict(outputs=serve(mh, ENGINE_GEN),
                                              ticks=mh.engine.ticks))
    out["multihost"]["stats"] = mh.stats()
    if rank == 0:
        log("[parallel rank 0] seconds: ready " + f"{out['ready_s']:.1f} after the spawn, "
            + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in out.items() if isinstance(v, dict)))
    return out


def _parallel4_rank(cfg70, cfg, prompt, prompts, started):
    """One of the four ranks of phase ``parallel4``: tp_generate at tp 4 on
    Llama-2-70B width (its first TP70_LAYERS layers, seed 7), then
    tppp_generate at pp 2 x tp 2 on the Llama-2-7B of phase model."""
    import torch.distributed as dist

    from qeft_tpu_torch.models.llama import init_kv_cache
    from qeft_tpu_torch.parallel.mesh import make_mesh
    from qeft_tpu_torch.parallel.tp_forward import (
        _local_cfg,
        tp_decode_step,
        tp_generate,
        tp_shard_packed_params,
    )
    from qeft_tpu_torch.parallel.tp_pp import tppp_generate, tppp_shard_params
    from qeft_tpu_torch.testing import build_packed_model

    rank = dist.get_rank()
    mesh = make_mesh((1, 4), ("dp", "tp"))
    dev = mesh.device
    prompt = torch.as_tensor(prompt, device=dev)
    out = {"ready_s": time.time() - started, "psum_ms": _collective_ms(mesh, "tp", rank)}
    sharded = tp_shard_packed_params(build_packed_model(cfg70, seed=7, device=dev), mesh, cfg70)
    torch.cuda.empty_cache()
    lcfg = _local_cfg(cfg70, 4)
    tp_generate(sharded, prompt, init_kv_cache(lcfg, 1, CACHE, device=dev), cfg70, mesh, 4)

    def gen():
        toks, _, logits = tp_generate(sharded, prompt, init_kv_cache(lcfg, 1, CACHE, device=dev),
                                      cfg70, mesh, PAR_NEW, return_logits=True)
        return dict(tokens=toks.cpu(), logits=logits[0].cpu())

    _rank_part(out, "tp4 70b", gen)
    cache = init_kv_cache(lcfg, 1, CACHE, device=dev)
    tok = prompt[:, :1]
    tp_generate(sharded, prompt, cache, cfg70, mesh, 1)
    with torch.inference_mode():
        out["tp4 70b"]["step"] = _rank_step_profile(
            "tp4 70b", lambda: tp_decode_step(sharded, tok, cache, PROMPT, cfg70, mesh), rank)
    del sharded, cache
    torch.cuda.empty_cache()

    grid = make_mesh((2, 2), ("pp", "tp"))
    batch = torch.as_tensor(np.stack(prompts[:TPPP_BATCH]), device=dev)
    params, local = tppp_shard_params(build_packed_model(cfg, seed=0, g=128, r=128, device=dev),
                                      init_kv_cache(cfg, TPPP_BATCH, CACHE, device=dev), grid,
                                      cfg)
    torch.cuda.empty_cache()
    _rank_part(out, "tppp", lambda: dict(tokens=tppp_generate(params, batch, local, cfg, grid,
                                                              PAR_NEW).cpu()))
    if rank == 0:
        log("[parallel4 rank 0] seconds: ready " + f"{out['ready_s']:.1f} after the spawn, "
            + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in out.items() if isinstance(v, dict)))
    return out


def _shard_kernel(row, label, p, m, randn, eps, bw, norm, n_layers):
    """K1 (with the norm, column-parallel) or K6 (without a slab,
    row-parallel) at one rank's stage shape against its plain version in
    f32, timed rotating over ``n_layers`` beside the plain version,
    ``torch.matmul`` on the (normalised) input and a pre-dequantized weight,
    and the bound; kept in ``row.d["shard_shapes"]``."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.testing import dense_linear

    k, n = p.in_features, p.out_features
    x = randn(m, k)
    if norm:
        lnw = (1.0 + randn(k, scale=0.1).float()).to(torch.bfloat16)

        def fn(l):
            return qmm.qgemv_stacked_fused(x, p, l, lnw=lnw, eps=eps)

        want = qmm.qgemv_stacked_fused_plain(f32(x), f32(p), 1, lnw=f32(lnw), eps=eps)
        plain = time_ms(lambda i: qmm.qgemv_stacked_fused_plain(x, p, i % n_layers, lnw=lnw,
                                                                eps=eps), inner=2, reps=3)
        h = qmm.rms_norm(x, lnw, eps)
    else:
        def fn(l):
            return qmm.qgemv_stacked(x, p, l)

        want = qmm.qgemv_stacked_plain(f32(x), f32(p), 1)
        plain = time_ms(lambda i: qmm.qgemv_stacked_plain(x, p, i % n_layers), inner=2, reps=3)
        h = x
    err = check(f"{row.d['name']} {label} {k}->{n} M={m}", fn(1), want)
    ms = time_ms(lambda i: fn(i % n_layers))
    w = dense_linear(_one_layer(p, 0))[0]
    lib = time_ms(lambda i: torch.matmul(h, w))
    del w
    nbytes = (k * n // 2 + 4 * (k // p.group_size) * n + 2 * p.n_outlier * n + 2 * m * (k + n)
              + (2 * k if norm else 0))
    bound, by = bound_ms(nbytes, 2 * m * (k + p.n_outlier) * n)
    row.d.setdefault("shard_shapes", []).append(dict(
        shape=f"{label} {k}->{n}", m=m, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
        bound_by=by, library_ms=lib, bound_ms_measured_hbm=nbytes / bw * 1e3))
    row.d["max_abs_err"] = max(row.d["max_abs_err"], err)
    log(f"    {label} M={m}: kernel {ms * 1e3:.1f} us ({bound / ms:.1%} of the bound), plain "
        f"{plain * 1e3:.1f} us, torch.matmul {lib * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by})")


def _shard_kernels(cfg, params, bw, rows):
    """K1 and K6 at the stage shapes one rank runs: the Llama-2-7B shards of
    rank 0 at tp 2 (its real weights, 32 layers rotating; down's 5,504 rows
    are 43 groups) and Llama-2-70B width at tp 4 (random weights, as many
    layers as keep the rotation out of L2)."""
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.parallel.mesh import Mesh
    from qeft_tpu_torch.parallel.tp_forward import tp_shard_packed_params
    from qeft_tpu_torch.probes import common
    from qeft_tpu_torch.testing import random_packed_linear

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    k1, k6 = rows["qgemv_stacked_fused"], rows["qgemv_stacked"]
    shard = tp_shard_packed_params(params, Mesh({"dp": 1, "tp": 2}, device=torch.device("cuda")),
                                   cfg)["layers"]
    log("[parallel] K1 and K6 at the shard shapes of Llama-2-7B at tp 2 (rank 0's weights)")
    for name, norm in (("qkv", True), ("o", False), ("upgate", True), ("down", False)):
        p = shard[name]
        if not norm:  # the row-parallel local contraction: no slab
            p = dataclasses.replace(p, oweight=None)
        for m in (1, ENGINE_SLOTS):
            _shard_kernel(k1 if norm else k6, f"7b tp2 {name}", p, m, randn, cfg.rms_norm_eps,
                          bw, norm, cfg.num_layers)
    del shard
    c70 = LLAMA_PRESETS["llama2-70b"]
    hq, hkv, dh, f, d = (c70.num_heads // 4, c70.num_kv_heads // 4, c70.head_dim,
                         c70.intermediate_size // 4, c70.hidden_size)
    log("[parallel] K1 and K6 at the shard shapes of Llama-2-70B width at tp 4 (random weights)")
    for name, k, n, norm in (("qkv", d, (hq + 2 * hkv) * dh, True), ("o", hq * dh, d, False),
                             ("upgate", d, 2 * f, True), ("down", f, d, False)):
        depth = common.n_copies(k * n // 2 + 4 * (k // 128) * n)
        p = random_packed_linear(gen, depth, k, n, 128, 128)
        if not norm:
            p = dataclasses.replace(p, oweight=None)
        _shard_kernel(k1 if norm else k6, f"70b tp4 {name}", p, 1, randn, c70.rms_norm_eps, bw,
                      norm, depth)
        del p


def _expect_rank(label, rank, counts, want):
    log(f"[{label}] rank {rank} launches {counts}; expected {want}")
    if counts != want:
        raise AssertionError(f"{label}: rank {rank} did not launch each kernel as expected")


def _against_single_device(label, got, ref, tokens, ref_tokens):
    """Teacher-forced logits of a parallel path against the single-device
    path's on the same tokens: max difference within ORACLE_RTOL of the
    single-device logit scale (bf16 partial sums are rounded before each
    psum, as JAX rounds them, so the paths differ by bf16 roundings: a wrong
    shard or a lost term moves logits by their scale); greedy agreement
    with the single-device tokens printed."""
    diff = (got.float() - ref.float().cpu()).abs().amax(dim=-1)
    scale = ref.abs().amax().item()
    worst = diff.max().item()
    argmax = (got.argmax(-1) == ref.argmax(-1).cpu()).sum().item()
    same = (tokens.reshape(-1).cpu() == ref_tokens.reshape(-1).cpu())
    prefix = int(same.long().cumprod(0).sum().item())
    log(f"[{label}] teacher-forced against the single-device path: max |logit diff| "
        f"{worst:.4g}, median {diff.median().item():.4g}, logit scale {scale:.4g}, bound "
        f"{ORACLE_RTOL * scale:.4g}; argmax agreement {argmax}/{len(diff)}; greedy tokens equal "
        f"to the single device's {int(same.sum())}/{same.numel()} (common prefix {prefix})")
    if not (torch.isfinite(got).all() and worst <= ORACLE_RTOL * scale):
        raise AssertionError(f"{label}: disagrees with the single-device path")
    return dict(max_logit_diff=worst, logit_scale=scale, argmax_agree=argmax,
                tokens_equal=int(same.sum()), common_prefix=prefix)


def _record_rank_paths(label, ranks, names):
    for rank, res in enumerate(ranks):
        for name in names:
            PATH_LAUNCHES[f"{label} {name} rank {rank}"] = res[name]["launches"]


def phase_parallel(cfg, params, prompt, tokens, int8_tokens, bw, rows):
    """parallel: K1 and K6 at the rank shapes (`_shard_kernels`); then two
    ranks on the card (`_parallel_rank`), their launches checked per token
    and layer and every output held against the single-device path here
    (`_check_parallel`), while ``run_benchmark --tp 2`` (engine and qeft)
    runs as subprocesses, each starting its own two ranks.  Returns the
    results and the running subprocesses, which phase parallel4 waits
    for."""
    from qeft_tpu_torch.parallel.multihost import launch_ranks

    torch.cuda.empty_cache()  # the ranks share the card
    _shard_kernels(cfg, params, bw, rows)
    prompts = _engine_prompts(cfg)
    long_prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, SP_SEQ))
    tick = time.perf_counter()
    ranks = launch_ranks(_parallel_rank, 2, "cuda", cfg, prompt.cpu(), prompts, long_prompt,
                         time.time())
    log(f"[parallel] two ranks ran in {time.perf_counter() - tick:.1f} s (spawn, build and "
        "every part)")
    # the CLIs run beside this phase's checks and phase parallel4's ranks
    cli = _tp_cli_start()
    try:
        return _check_parallel(cfg, params, prompt, tokens, int8_tokens, ranks, prompts,
                               long_prompt), cli
    except BaseException:
        for proc in cli[1].values():
            proc.kill()
            proc.wait()
        raise


def _check_parallel(cfg, params, prompt, tokens, int8_tokens, ranks, prompts, long_prompt):
    """Phase parallel's launches and outputs against the single-device path."""
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.llama import init_kv_cache, llama_decode_step, llama_prefill

    api = get_model_api("llama")
    n = cfg.num_layers
    _record_rank_paths("parallel", ranks, ("tp bf16", "tp int8", "tp engine", "pp", "sp",
                                           "multihost"))
    steps = PAR_NEW - 1
    out = {}
    for label, quantized, attn in (("tp bf16", False, "decode_attention"),
                                   ("tp int8", True, "decode_attention_int8")):
        want = {"qgemv_stacked_fused": 2 * n * steps, "qgemv_stacked": 2 * n * steps,
                attn: n * steps, "qgemm": 4 * n, "flash_window_attention": n}
        for rank, res in enumerate(ranks):
            _expect_rank(label, rank, res[label]["launches"], want)
        r0 = ranks[0][label]
        if not torch.equal(r0["tokens"], ranks[1][label]["tokens"]):
            raise AssertionError(f"{label}: the ranks generated different tokens")
        log(f"[{label}] tp_generate at tp 2: {PROMPT} + {PAR_NEW} greedy in {r0['seconds']:.3f} "
            f"s of host clock ({PAR_NEW / r0['seconds']:.2f} tok/s, host-staged collectives)")
        ref = _teacher_forced(params, cfg, api, prompt, r0["tokens"].to(prompt.device), quantized=quantized)
        single = (int8_tokens if quantized else tokens)[:, :PAR_NEW]
        out[label] = dict(seconds=r0["seconds"],
                          **_against_single_device(label, r0["logits"], ref, r0["tokens"], single))
    out["step"] = [r["tp bf16"]["step"] for r in ranks]
    out["psum_ms"] = [r["psum_ms"] for r in ranks]

    ticks = ranks[0]["tp engine"]["ticks"]
    want = {"qgemv_stacked_fused": 2 * n * ticks, "qgemv_stacked": 2 * n * ticks,
            "qgemm": 4 * n * ENGINE_REQUESTS, "flash_window_attention": n * (ticks + ENGINE_REQUESTS)}
    for rank, res in enumerate(ranks):
        _expect_rank("tp engine", rank, res["tp engine"]["launches"], want)
    served = ranks[0]["tp engine"]["outputs"]
    if served != ranks[1]["tp engine"]["outputs"] or sorted(served) != list(range(ENGINE_REQUESTS)):
        raise AssertionError("tp engine: the ranks served different tokens or not every request")
    outputs = [served[i] for i in range(ENGINE_REQUESTS)]
    same = sum(a == b for o, s in zip(outputs, SERVED["engine bf16"]) for a, b in zip(o, s))
    log(f"[tp engine] Engine(mesh) at tp 2: {ENGINE_REQUESTS} requests of {ENGINE_CTX} + "
        f"{TP_ENGINE_GEN}, {ticks} ticks in {ranks[0]['tp engine']['seconds']:.3f} s (host "
        f"clock); tokens equal to the single-device engine's (its first {TP_ENGINE_GEN} of each "
        f"request) {same}/{ENGINE_REQUESTS * TP_ENGINE_GEN}")
    out["tp engine"] = _check_served(cfg, params, prompts, outputs, "tp engine", False)

    pp_tokens = ranks[0]["pp"]["tokens"]
    mb_runs = PP_MICRO * steps
    want = {"qgemv_stacked_fused": 4 * (n // 2) * mb_runs, "decode_attention": (n // 2) * mb_runs,
            "qgemm": 4 * (n // 2) * PP_MICRO, "flash_window_attention": (n // 2) * PP_MICRO}
    for rank, res in enumerate(ranks):
        _expect_rank("pp", rank, res["pp"]["launches"], want)
        if not torch.equal(res["pp"]["tokens"], pp_tokens):
            raise AssertionError("pp: the stages returned different tokens")
    log(f"[pp] pp_generate at pp 2, batch {PP_BATCH} in {PP_MICRO} microbatches: {PROMPT} + "
        f"{PAR_NEW} greedy in {ranks[0]['pp']['seconds']:.3f} s (host clock)")
    out["pp"] = _check_served(cfg, params, prompts[:PP_BATCH], pp_tokens.tolist(), "pp", False)

    sp = ranks[0]["sp"]
    want = {"qgemm": 4 * n, "qgemv": 4 * n * SP_DECODE}
    for rank, res in enumerate(ranks):
        _expect_rank("sp", rank, res["sp"]["launches"], want)
    with torch.inference_mode():
        lp = torch.as_tensor(long_prompt, device="cuda")
        cache = init_kv_cache(cfg, 1, SP_SEQ + SP_DECODE, device="cuda")
        ref, cache = llama_prefill(params, lp, cache, cfg)
        ref_rows, ref_argmax = ref[0, ::SP_ROW_STRIDE].float(), ref[0].argmax(-1).cpu()
        del ref
        dec = []
        for i, t in enumerate(sp["tokens"]):
            lg, cache = llama_decode_step(params, torch.tensor([[t]], device="cuda"), cache,
                                          SP_SEQ + i, cfg)
            dec.append(lg[0].float())
        del cache
    agree = (sp["prefill_argmax"] == ref_argmax).sum().item()
    log(f"[sp] llama_prefill_sp at sp 2 over S = {SP_SEQ}: argmax equal to the single-device "
        f"prefill's (K3 over the whole window) at {agree}/{SP_SEQ} positions; "
        f"{ranks[0]['sp']['seconds']:.3f} s with {SP_DECODE} decode steps (host clock)")
    out["sp prefill"] = _against_single_device("sp prefill", sp["prefill_rows"], ref_rows,
                                               sp["prefill_argmax"], ref_argmax)
    out["sp decode"] = _against_single_device("sp decode", sp["logits"], torch.stack(dec),
                                              torch.tensor(sp["tokens"][1:]),
                                              torch.stack(dec)[:-1].argmax(-1))

    mh = {}
    for rank, res in enumerate(ranks):
        t = res["multihost"]["ticks"]
        _expect_rank("multihost", rank, res["multihost"]["launches"],
                     {"qgemv_stacked": 4 * n * t, "qgemm": 4 * n * ENGINE_REQUESTS // 2,
                      "flash_window_attention": n * (t + ENGINE_REQUESTS // 2)})
        if sorted(res["multihost"]["outputs"]) != list(range(rank, ENGINE_REQUESTS, 2)):
            raise AssertionError(f"multihost: rank {rank} served another share")
        mh.update(res["multihost"]["outputs"])
        stats = res["multihost"]["stats"]
        if (stats["requests_total"], stats["tokens_total"]) != (ENGINE_REQUESTS,
                                                                ENGINE_REQUESTS * ENGINE_GEN):
            raise AssertionError(f"multihost: rank {rank}'s totals {stats}")
    equal = all(mh[i] == SERVED["engine bf16"][i] for i in range(ENGINE_REQUESTS))
    log(f"[multihost] MultiHostEngine over 2 ranks as dp replicas (8 requests each): tokens "
        f"equal to the single-device engine's for every request: {equal}; stats {stats}")
    if not equal:  # the replicas run the single-device engine's arithmetic row for row
        raise AssertionError("multihost: a replica served other tokens than the single device")
    out["multihost"] = dict(stats=stats, tokens_equal=equal,
                            seconds=[r["multihost"]["seconds"] for r in ranks])
    return out


def _tp_cli_start():
    """``run_benchmark --tp 2`` for --method engine and qeft as subprocesses,
    started together (each starts its own two ranks); `_tp_cli_finish`
    waits for them."""
    base = [sys.executable, "-m", "qeft_tpu_torch.run_benchmark", "--tp", "2", "--reps", "1",
            "--gen", str(TP_CLI_GEN)]
    runs = {"engine": base + ["--method", "engine", "--batch", str(ENGINE_SLOTS), "--requests",
                              str(ENGINE_SLOTS)],
            "qeft": base + ["--method", "qeft"]}
    return time.perf_counter(), {m: subprocess.Popen(argv, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True)
                                 for m, argv in runs.items()}


def _tp_cli_finish(cli):
    """Each ``run_benchmark --tp 2``'s result line (with its tp); a failure
    fails the phase, and no subprocess outlives the call."""
    tick, procs = cli
    lines = {}
    try:
        for method, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"run_benchmark --method {method} --tp 2 failed:\n"
                                     f"{stderr[-3000:]}")
            lines[method] = json.loads(stdout.strip().splitlines()[-1])
            log(f"[parallel-cli] run_benchmark --method {method} --tp 2: {lines[method]}")
            if lines[method].get("tp") != 2:
                raise AssertionError(f"run_benchmark --method {method} --tp 2 printed no tp")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[parallel-cli] both done {time.perf_counter() - tick:.1f} s after their start")
    return lines


def phase_parallel4(cfg, params, prompt, bw, rows, cli):
    """parallel4: four ranks on the card (`_parallel4_rank`): tp 4 on
    Llama-2-70B width at TP70_LAYERS layers (16 query over 2 kv heads a
    rank) and pp 2 x tp 2 on the Llama-2-7B; launches checked, outputs held
    against the single-device path here; then phase parallel's
    ``run_benchmark --tp 2`` subprocesses (``cli``) waited for."""
    try:
        out = _parallel4(cfg, params, prompt)
    finally:
        lines = _tp_cli_finish(cli)
    out["cli"] = lines
    return out


def _parallel4(cfg, params, prompt):
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.parallel.multihost import launch_ranks
    from qeft_tpu_torch.testing import build_packed_model

    api = get_model_api("llama")
    cfg70 = dataclasses.replace(LLAMA_PRESETS["llama2-70b"], num_layers=TP70_LAYERS)
    prompts = _engine_prompts(cfg)
    tick = time.perf_counter()
    ranks = launch_ranks(_parallel4_rank, 4, "cuda", cfg70, cfg, prompt.cpu(), prompts,
                         time.time())
    log(f"[parallel4] four ranks ran in {time.perf_counter() - tick:.1f} s")
    _record_rank_paths("parallel4", ranks, ("tp4 70b", "tppp"))
    steps, n70, n = PAR_NEW - 1, TP70_LAYERS, cfg.num_layers
    want = {"qgemv_stacked_fused": 2 * n70 * steps, "qgemv_stacked": 2 * n70 * steps,
            "decode_attention": n70 * steps, "qgemm": 4 * n70, "flash_window_attention": n70}
    for rank, res in enumerate(ranks):
        _expect_rank("tp4 70b", rank, res["tp4 70b"]["launches"], want)
    r0 = ranks[0]["tp4 70b"]
    params70 = build_packed_model(cfg70, seed=7, device="cuda")
    ref = _teacher_forced(params70, cfg70, api, prompt, r0["tokens"].to(prompt.device))
    single, _ = generate(params70, prompt, api.init_cache(cfg70, 1, CACHE, device="cuda"), cfg70,
                         PAR_NEW, api=api, device="cuda")
    del params70
    torch.cuda.empty_cache()
    log(f"[tp4 70b] tp_generate at tp 4 on {TP70_LAYERS} layers of Llama-2-70B width: {PROMPT} + "
        f"{PAR_NEW} greedy in {r0['seconds']:.3f} s (host clock)")
    out = {"tp4 70b": dict(seconds=r0["seconds"], step=[r["tp4 70b"]["step"] for r in ranks],
                           psum_ms=[r["psum_ms"] for r in ranks],
                           **_against_single_device("tp4 70b", r0["logits"], ref, r0["tokens"],
                                                    single))}
    mb_runs = 2 * steps  # TPPP_BATCH rows in two microbatches
    want = {"qgemv_stacked_fused": 2 * (n // 2) * mb_runs, "qgemv_stacked": 2 * (n // 2) * mb_runs,
            "decode_attention": (n // 2) * mb_runs, "qgemm": 4 * (n // 2) * 2,
            "flash_window_attention": (n // 2) * 2}
    toks = ranks[0]["tppp"]["tokens"]
    for rank, res in enumerate(ranks):
        _expect_rank("tppp", rank, res["tppp"]["launches"], want)
        if not torch.equal(res["tppp"]["tokens"], toks):
            raise AssertionError("tppp: the ranks returned different tokens")
    log(f"[tppp] tppp_generate at pp 2 x tp 2, batch {TPPP_BATCH}: {PROMPT} + {PAR_NEW} greedy "
        f"in {ranks[0]['tppp']['seconds']:.3f} s (host clock)")
    out["tppp"] = _check_served(cfg, params, prompts[:TPPP_BATCH], toks.tolist(), "tppp", False)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel training, the multi-host dry run, unfused trees,
# the kernel ablations


def _own_slice_gather_grad(g, mesh, width):
    """The planted fault of phase tp-train: the Megatron shortcut for the
    gather's backward (this rank's own slice of the cotangent), which drops
    what the o_reorder gather sent to the other rank's K rows."""
    return g.narrow(-1, mesh.index("tp") * width, width).contiguous()


def _tp_train_kernels(bw, rows):
    """K2 and K7 at the shard shapes one rank of tp-2 training runs at
    Llama-2-7B width, TP_TRAIN_ROWS rows (random weights, 2 layers), against
    their plain versions, timed beside their bounds and ``torch.matmul``;
    kept under the K2 and K7 rows as ``tp_train_shards``."""
    from qeft_tpu_torch.ops import qmm
    from qeft_tpu_torch.ops.qlinear import matmul_f32
    from qeft_tpu_torch.testing import dense_linear, random_packed_linear

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    m = TP_TRAIN_ROWS
    log(f"[tp-train] K2 qgemm and K7 qgemm_t at the tp 2 shard shapes, M={m}")
    for label, k, n, r in TP_TRAIN_SHARDS:
        p = random_packed_linear(gen, 2, k, n, 128, max(r, 1), fan_in=True)
        if not r:
            p = dataclasses.replace(p, oweight=None)
        x, gy = randn(m, k), randn(m, n)
        tail = matmul_f32(gy, p.oweight[1].t()) if r else None
        w = dense_linear(_one_layer(p, 0))[0]
        wbytes = k * n // 2 + 4 * (k // 128) * n
        for name, key, fn, plain, lib, nbytes, flops in (
                ("K2", "qgemm", lambda l: qmm.qgemm(x, p.layer(l)),
                 lambda l: qmm.qgemm_plain(x, p.layer(l)), lambda: torch.matmul(x, w),
                 wbytes + 2 * r * n + 2 * m * (k + n), 2 * m * (k + r) * n),
                ("K7", "qgemm_t", lambda l: qmm.qgemm_t(gy, p.layer(l), tail),
                 lambda l: qmm.qgemm_t_plain(gy, p.layer(l), tail),
                 lambda: torch.matmul(gy, w.t()), wbytes + 2 * m * (n + k) + 4 * m * r,
                 2 * m * k * n)):
            want = (qmm.qgemm_plain(f32(x), f32(p.layer(1))) if name == "K2"
                    else qmm.qgemm_t_plain(f32(gy), f32(p.layer(1)), tail))
            err = check(f"{name} tp2 {label} M={m}", fn(1), want)
            ms = time_ms(lambda i: fn(i % 2))
            pms = time_ms(lambda i: plain(i % 2), inner=2, reps=3)
            lms = time_ms(lambda i: lib())
            bound, by = bound_ms(nbytes, flops)
            d = rows[key].d
            d["max_abs_err"] = max(d["max_abs_err"], err)
            d.setdefault("tp_train_shards", {})[label] = dict(
                m=m, ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by, library_ms=lms)
            log(f"    {name} {label} {k}->{n}: kernel {ms * 1e3:.1f} us ({bound / ms:.1%} of the "
                f"bound), plain {pms * 1e3:.1f} us, torch.matmul {lms * 1e3:.1f} us, bound "
                f"{bound * 1e3:.2f} us ({by})")
        del p, w


def _tp_train_model(cfg, device):
    """The model of phase tp-train: `testing.build_packed_model`'s tree
    (seed 0, its o_reorder a random OGR compaction) with every stage's
    weights drawn at fan-in scale (``random_packed_linear(fan_in=True)``).
    The llama test distribution gives every weight column a positive mean;
    the residual stream's common mode then swamps the signal in bf16, and
    the early layers' slab gradients of any two bf16 computations part
    (PERF.md section 6)."""
    from qeft_tpu_torch.testing import build_packed_model, random_packed_linear

    params = build_packed_model(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    layers = params["layers"]
    for name in ("qkv", "o", "upgate", "down"):
        k, n = layers[name].in_features, layers[name].out_features
        layers[name] = random_packed_linear(gen, cfg.num_layers, k, n, 128, 128, fan_in=True)
    return params


def _tp_train_rank(cfg, ids, labels, started):
    """One of the two ranks of phase tp-train: the TP_TRAIN_LAYERS-layer
    model (seed 0) built on the card and sharded; the loss and slab
    gradients sound and with the planted own-slice backward; then
    TP_TRAIN_STEPS steps of make_tp_train_step with run_finetune's
    defaults, their launches and times.  Host values only."""
    import torch.distributed as dist

    from qeft_tpu_torch.finetune import TrainConfig, make_optimizer
    from qeft_tpu_torch.ops import cuda_lib
    from qeft_tpu_torch.parallel import tp_train
    from qeft_tpu_torch.parallel.mesh import make_mesh

    rank = dist.get_rank()
    mesh = make_mesh((1, 2), ("dp", "tp"))
    ow, frozen = tp_train.tp_shard_wct(_tp_train_model(cfg, mesh.device), mesh, cfg)
    torch.cuda.empty_cache()
    ids, labels = ids.to(mesh.device), labels.to(mesh.device)
    out = {"ready_s": time.time() - started}
    loss_and_grad = tp_train.make_tp_loss_and_grad(cfg, mesh, ow, frozen, remat=True)

    def grads():
        loss, g = loss_and_grad(ow, frozen, ids, labels)
        return dict(loss=float(loss), grads={k: torch.stack(v).float().cpu()
                                             for k, v in g.items()})

    _rank_part(out, "oracle", grads)
    real = tp_train._gather_grad
    tp_train._gather_grad = _own_slice_gather_grad
    try:
        _rank_part(out, "planted", grads)
    finally:
        tp_train._gather_grad = real
    tc = TrainConfig(learning_rate=2e-4, total_steps=100, warmup_ratio=0.03,
                     max_grad_norm=0.3, lr_schedule="cosine", remat=True)
    opt = make_optimizer(tc, ow, tp_train.tp_grad_norm(mesh, ow))
    step = tp_train.make_tp_train_step(cfg, opt, mesh, ow, frozen)

    def steps():
        res = dict(losses=[], host_ms=[], per_step=[])
        for _ in range(TP_TRAIN_STEPS):
            before = dict(cuda_lib.launches)
            torch.cuda.synchronize()
            tick = time.perf_counter()
            res["losses"].append(float(step(ow, frozen, ids, labels)))
            torch.cuda.synchronize()
            res["host_ms"].append((time.perf_counter() - tick) * 1e3)
            res["per_step"].append({k: v - before.get(k, 0) for k, v in cuda_lib.launches.items()
                                    if v - before.get(k, 0)})
        return res

    _rank_part(out, "steps", steps)
    if rank == 0:
        log(f"[tp-train rank 0] ready {out['ready_s']:.1f} s after the spawn; oracle "
            f"{out['oracle']['seconds']:.1f} s, planted {out['planted']['seconds']:.1f} s, "
            f"{TP_TRAIN_STEPS} steps {out['steps']['seconds']:.1f} s")
    return out


def _assemble_tp(ranks, key, cfg):
    """The global [L, r, N] slab gradients from the two ranks' shards (the
    column stages' interleave undone)."""
    from qeft_tpu_torch.parallel.tp_forward import _interleave_perm

    hq, hkv, dh, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    perms = {"qkv": _interleave_perm([hq * dh, hkv * dh, hkv * dh], 2),
             "upgate": _interleave_perm([f, f], 2)}
    out = {}
    for name, g in ranks[0][key]["grads"].items():
        if name in perms:
            cat = torch.cat([r[key]["grads"][name] for r in ranks], dim=-1)
            out[name] = cat[..., torch.as_tensor(np.argsort(perms[name]))]
        else:
            if not torch.equal(ranks[1][key]["grads"][name], g):
                raise AssertionError(f"tp-train: the ranks' replicated {name} gradients differ")
            out[name] = g
    return out


def phase_tp_train(cfg, bw, rows):
    """tp-train: K2 and K7 at the rank shapes (`_tp_train_kernels`); then two
    ranks on the card (`_tp_train_rank`) train the weak columns of
    TP_TRAIN_LAYERS layers of Llama-2-7B width (`_tp_train_model`) at tp 2
    on one batch of TP_TRAIN_BATCH x TRAIN_SEQ.  The oracle: the loss and every slab's
    gradient against the single-device ``wct_loss`` backward on the same
    weights and batch here -- the loss within LOSS_RTOL, each slab within
    TP_GRAD_FRO relative (Frobenius) and ORACLE_RTOL of its scale (max):
    both are bf16 kernel paths, the tp one rounding each row-parallel
    partial sum to bf16 before the psum -- and the planted own-slice
    backward of the gather must fail it.  K2 and K7 counted per rank and
    step."""
    from qeft_tpu_torch.finetune import split_wct, wct_loss
    from qeft_tpu_torch.parallel.multihost import launch_ranks

    torch.cuda.empty_cache()
    _tp_train_kernels(bw, rows)
    small = dataclasses.replace(cfg, num_layers=TP_TRAIN_LAYERS)
    ids, labels = (t[:TP_TRAIN_BATCH] for t in next(_sft_batches(cfg)))
    ow, frozen = split_wct(_tp_train_model(small, "cuda"))
    ref_loss = wct_loss(ow, frozen, ids, labels, small, remat=True)
    ref_loss.backward()
    ref = {k: torch.stack([t.grad for t in v]).float().cpu() for k, v in ow.items()}
    ref_loss = ref_loss.item()
    del ow, frozen
    torch.cuda.empty_cache()
    tick = time.perf_counter()
    ranks = launch_ranks(_tp_train_rank, 2, "cuda", small, ids.cpu(), labels.cpu(), time.time())
    log(f"[tp-train] two ranks ran in {time.perf_counter() - tick:.1f} s (spawn, build and "
        "every part)")
    for rank, res in enumerate(ranks):
        PATH_LAUNCHES[f"tp-train steps rank {rank}"] = res["steps"]["launches"]
    n_lin = 4 * small.num_layers
    per_step = {"qgemm": 2 * n_lin, "qgemm_t": n_lin - 1}
    for rank, res in enumerate(ranks):
        for i, counts in enumerate(res["steps"]["per_step"]):
            if counts != per_step:
                raise AssertionError(f"tp-train: rank {rank} step {i + 1} launched {counts}, "
                                     f"expected {per_step}")
        log(f"[tp-train] rank {rank}: {TP_TRAIN_STEPS} steps, losses "
            f"{[round(x, 6) for x in res['steps']['losses']]}, host clock "
            f"{[round(x, 1) for x in res['steps']['host_ms']]} ms (host-staged Gloo on one card: "
            f"no speed result); launches {per_step} a step, as expected")
    if ranks[0]["steps"]["losses"] != ranks[1]["steps"]["losses"]:
        raise AssertionError("tp-train: the ranks' losses differ")
    out = {"ref_loss": ref_loss, "steps": ranks[0]["steps"]}
    ok = {}
    for key in ("oracle", "planted"):
        loss = ranks[0][key]["loss"]
        got = _assemble_tp(ranks, key, small)
        good = abs(loss - ref_loss) <= LOSS_RTOL * ref_loss
        worst_fro = worst_max = 0.0
        for name, g in ref.items():
            for l in range(small.num_layers):
                a, b = got[name][l], g[l]
                fro = ((a - b).norm() / b.norm()).item()
                mx = ((a - b).abs().max() / b.abs().max()).item()
                worst_fro, worst_max = max(worst_fro, fro), max(worst_max, mx)
                good &= fro <= TP_GRAD_FRO and mx <= ORACLE_RTOL
                out.setdefault(key, {})[f"{name}{l}"] = dict(fro=fro, max=mx)
        ok[key] = good
        log(f"[tp-train] {key}: loss {loss:.6f} against the single device's {ref_loss:.6f} "
            f"(|diff| {abs(loss - ref_loss):.3g}, bound {LOSS_RTOL * ref_loss:.3g}); slab "
            f"gradients: worst relative Frobenius error {worst_fro:.4g} (bound {TP_GRAD_FRO}), "
            f"worst max |diff| over the scale {worst_max:.4g} (bound {ORACLE_RTOL}) -> "
            + ("passes" if good else "fails"))
        for name in ref:
            log(f"    {key} {name}: " + ", ".join(
                f"layer {l} {out[key][f'{name}{l}']['fro']:.4g} / "
                f"{out[key][f'{name}{l}']['max']:.4g}" for l in range(small.num_layers)))
    if not ok["oracle"]:
        raise AssertionError("tp-train: the tensor-parallel gradients disagree with the single "
                             "device")
    if ok["planted"]:
        raise AssertionError("tp-train: the oracle passed the own-slice gather backward")
    return out


def phase_dryrun(cfg):
    """dryrun: `multihost_dryrun` as 2 hosts x tp 2 = 4 ranks on the card at
    Llama-2-7B width and DRYRUN_LAYERS layers: WCT steps on each host's rows
    (losses equal on every rank), the dp-sharded decode against the
    full-batch reference (bf16: within 0.1 of the logit scale, decisive
    argmax equal), MultiHostEngine against the single-process engine,
    request for request.  Each rank's legs are main paths."""
    from qeft_tpu_torch import multihost_dryrun as md

    small = dataclasses.replace(cfg, num_layers=DRYRUN_LAYERS)
    sizes = md.Sizes(train_rows=1, train_seq=TRAIN_SEQ, train_steps=2, decode_rows=2,
                     decode_ctx=PROMPT, decode_steps=4, requests=8, new_tokens=16,
                     group_size=128, weak=128)
    torch.cuda.empty_cache()
    tick = time.perf_counter()
    ranks = md.run(small, sizes, device="cuda")
    log(f"[dryrun] four ranks (2 hosts x tp 2) ran in {time.perf_counter() - tick:.1f} s")
    n_lin = 4 * small.num_layers
    want_train = {"qgemm": 2 * 2 * n_lin, "qgemm_t": 2 * (n_lin - 1)}
    for rank, res in enumerate(ranks):
        for leg in ("train", "decode", "engine"):
            PATH_LAUNCHES[f"dryrun {leg} rank {rank}"] = res[leg]["launches"]
        _expect_rank("dryrun train", rank, res["train"]["launches"], want_train)
        d, e = res["decode"], res["engine"]
        log(f"[dryrun] rank {rank} {res['coords']}: losses {res['train']['losses']} "
            f"({res['train']['seconds']:.1f} s); dp-sharded decode max |logit diff| "
            f"{d['max_logit_diff']:.4g} of scale {d['logit_scale']:.4g} (bound {d['bound']:.4g}), "
            f"argmax flips within the margin {d['argmax_flips_within_margin']} "
            f"({d['seconds']:.1f} s); engine requests {e['requests']} equal to the "
            f"single-process engine's, totals {e['stats']} ({e['seconds']:.1f} s); launches "
            f"decode {d['launches']}, engine {e['launches']}")
    if len({tuple(r["train"]["losses"]) for r in ranks}) != 1:
        raise AssertionError("dryrun: the hosts' losses differ")
    return {"losses": ranks[0]["train"]["losses"],
            "decode": [r["decode"]["max_logit_diff"] for r in ranks]}


@torch.inference_mode()
def phase_unfused(prompt):
    """unfused: Llama-2-7B width at UNFUSED_LAYERS layers packed without the
    global reorder and unfused (every linear its own ``reorder_ids``):
    ``generate`` PROMPT + UNFUSED_NEW through the graph and eagerly (tokens
    equal), K5 counted 7 times a layer and token; the tokens teacher-forced
    through it and through the dense model dequantized from the same tree
    (ORACLE_RTOL of the logit scale).  Then UNFUSED_F32W tokens under
    QEFT_GEMV_F32W=0: K5's bf16w variant."""
    from qeft_tpu_torch.generate import generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.models.llama import LLAMA_PRESETS
    from qeft_tpu_torch.testing import build_packed_model, dense_model

    api = get_model_api("llama")
    ucfg = dataclasses.replace(LLAMA_PRESETS["llama2-7b"], num_layers=UNFUSED_LAYERS)
    params = build_packed_model(ucfg, seed=5, device="cuda", fuse_stages=False, reorder=False)
    n, steps = ucfg.num_layers, UNFUSED_NEW - 1

    def new_cache():
        return api.init_cache(ucfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")

    generate(params, prompt, new_cache(), ucfg, 8, api=api, device="cuda")
    with counted("unfused generate") as c:
        tick = time.perf_counter()
        tokens, _ = generate(params, prompt, new_cache(), ucfg, UNFUSED_NEW, api=api,
                             device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - tick
    want = {"qgemv": 7 * n * steps, "qgemm": 7 * n, "flash_window_attention": n,
            "decode_attention": n * steps}
    log(f"[unfused] generate {PROMPT} + {UNFUSED_NEW} on {n} layers of Llama-2-7B width packed "
        f"without the reorder, unfused, through the graph: {UNFUSED_NEW / dt:.2f} tok/s (host "
        f"clock); launches {c.counts}; expected {want}")
    if c.counts != want:
        raise AssertionError("unfused: did not launch each kernel as expected")
    eager, _ = generate(params, prompt, new_cache(), ucfg, UNFUSED_NEW, api=api, device="cuda",
                        graph=False)
    if not torch.equal(eager, tokens):
        raise AssertionError("unfused: the graph's tokens differ from the eager loop's")
    got = _teacher_forced(params, ucfg, api, prompt, tokens)
    dense = dense_model(params)
    ref = _teacher_forced(dense, ucfg, api, prompt, tokens)
    del dense
    torch.cuda.empty_cache()
    diff = (got - ref).abs().amax(dim=-1)
    scale, worst = ref.abs().amax().item(), diff.max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).sum().item()
    log(f"[unfused] graph tokens equal to the eager loop's; teacher-forced against the dense "
        f"model dequantized from the tree: max |logit diff| {worst:.4g}, logit scale "
        f"{scale:.4g}, bound {ORACLE_RTOL * scale:.4g}; argmax agreement {agree}/{UNFUSED_NEW}")
    if not (torch.isfinite(got).all() and worst <= ORACLE_RTOL * scale):
        raise AssertionError("unfused: disagrees with the dense model")
    with environ(QEFT_GEMV_F32W="0"), counted("unfused f32w=0 generate") as c:
        generate(params, prompt, new_cache(), ucfg, UNFUSED_F32W, api=api, device="cuda",
                 graph=False)
    want = {"qgemv_bf16w": 7 * n * (UNFUSED_F32W - 1), "qgemm": 7 * n,
            "flash_window_attention": n, "decode_attention": n * (UNFUSED_F32W - 1)}
    log(f"[unfused] QEFT_GEMV_F32W=0: launches {c.counts}; expected {want}")
    if c.counts != want:
        raise AssertionError("unfused f32w=0: did not launch each kernel as expected")
    return dict(tok_s=UNFUSED_NEW / dt, max_logit_diff=worst, logit_scale=scale,
                argmax_agree=agree)


def _bf16w_stages(cfg, params, bw, rows):
    """The bf16w variants of K1, K6 and K5 (QEFT_GEMV_F32W=0) at the four
    Llama-2-7B stage shapes, M = 1, on the model's weights (layer 1; timed
    rotating over the layers), each against its plain version on the same
    bf16 inputs and timed beside the default kernel on the same inputs."""
    from qeft_tpu_torch.ops import qmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    layers, n_layers, eps = params["layers"], cfg.num_layers, cfg.rms_norm_eps
    log("[ablations] K1, K6 and K5 bf16w (QEFT_GEMV_F32W=0) at the four stage shapes, M=1, "
        "against their plain versions, timed beside the default kernels")
    for name, norm, resid in K1_STAGES:
        p = layers[name]
        k, n = p.in_features, p.out_features
        x = randn(1, k)
        lnw = (1.0 + randn(k, scale=0.1).float()).to(torch.bfloat16) if norm else None
        res = randn(1, n, scale=4.0) if resid else None
        kw = dict(lnw=lnw, residual=res, eps=eps)
        calls = {"qgemv_stacked_fused_bf16w": lambda l: qmm.qgemv_stacked_fused(x, p, l, **kw),
                 "qgemv_stacked_bf16w": lambda l: qmm.qgemv_stacked(x, p, l),
                 "qgemv_bf16w": lambda l: qmm.qgemv(x, p.layer(l))}
        plains = {"qgemv_stacked_fused_bf16w": lambda l: qmm.qgemv_stacked_fused_plain(
                      x, p, l, **kw),
                  "qgemv_stacked_bf16w": lambda l: qmm.qgemv_stacked_plain(x, p, l),
                  "qgemv_bf16w": lambda l: qmm.qgemv_plain(x, p.layer(l))}
        wbytes = k * n // 2 + 4 * (k // p.group_size) * n + 2 * p.n_outlier * n
        for key, fn in calls.items():
            default = time_ms(lambda i: fn(i % n_layers))
            default_out = fn(1)
            with environ(QEFT_GEMV_F32W="0"):
                got, want = fn(1), plains[key](1)
                err = check(f"{key} {name} {k}->{n} M=1", got, want)
                mean_err, gap = check_variant(f"{key} {name}", got, want, default_out)
                ms = time_ms(lambda i: fn(i % n_layers))
                plain = time_ms(lambda i: plains[key](i % n_layers), inner=2, reps=3)
            fused = key == "qgemv_stacked_fused_bf16w"
            nbytes = (wbytes + 2 * (k + n) + (2 * k if fused and norm else 0)
                      + (2 * n if fused and resid else 0))
            b = rows[key].add(err, ms, plain, None, nbytes, 2 * k * n, bw)
            d = rows[key].d
            d["default_ms"] = d.get("default_ms", 0.0) + default
            d["mean_abs_err"] = max(d.get("mean_abs_err", 0.0), mean_err)
            d["mean_abs_dist_default"] = min(d.get("mean_abs_dist_default", gap), gap)
            log(f"    {key} {name}: kernel {ms * 1e3:.1f} us ({b[0] / ms:.1%} of the bound), the "
                f"default kernel {default * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound "
                f"{b[0] * 1e3:.2f} us ({b[1]})")


def phase_ablations(cfg, params, prompt, tokens, bw, rows):
    """ablations: ``run_benchmark --method qeft-x`` (QEFT_PALLAS=0: no
    K1/K2/K5/K6/K7 launched) and the model's logits under QEFT_PALLAS=0
    teacher-forced against the kernel path's (ORACLE_RTOL of the scale);
    the bf16w variants of K1, K6 and K5 at the stage shapes
    (`_bf16w_stages`) and K1's and K6's on a decode path
    (``generate`` under QEFT_GEMV_F32W=0, K6 with QEFT_FUSED_DECODE=0 too);
    one ``profile_trace`` of graph-replayed decode steps, its trace naming
    K1's kernel."""
    from qeft_tpu_torch import run_benchmark
    from qeft_tpu_torch.generate import DecodeLoop, SampleConfig, generate
    from qeft_tpu_torch.models.api import get_model_api
    from qeft_tpu_torch.utils import profile_trace

    api = get_model_api("llama")
    linear = ("qgemv_stacked_fused", "qgemv_stacked", "qgemv", "qgemm", "qgemm_t")
    with counted("qeft-x benchmark") as c:
        res = run_benchmark.main(["--method", "qeft-x", "--context", str(PROMPT), "--gen",
                                  str(ABLATION_GEN), "--reps", "1"])
    log(f"[ablations] run_benchmark --method qeft-x: {res}; launches {c.counts}")
    if any(k in c.counts for k in linear) or res["method"] != "qeft-x":
        raise AssertionError("qeft-x launched a hand-written linear kernel")
    toks = tokens[:, :ABLATION_GEN]
    ref = _teacher_forced(params, cfg, api, prompt, toks)
    with environ(QEFT_PALLAS="0"), counted("qeft-x teacher-forced") as c:
        got = _teacher_forced(params, cfg, api, prompt, toks)
    worst, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"[ablations] QEFT_PALLAS=0 teacher-forced over {ABLATION_GEN} tokens against the kernel "
        f"path: max |logit diff| {worst:.4g}, logit scale {scale:.4g}, bound "
        f"{ORACLE_RTOL * scale:.4g}; launches {c.counts}")
    if any(k in c.counts for k in linear) or not worst <= ORACLE_RTOL * scale:
        raise AssertionError("QEFT_PALLAS=0 disagrees with the kernel path")
    out = dict(qeft_x=res, pallas0_max_logit_diff=worst, logit_scale=scale)
    for key, line in (("qgemv_stacked_fused_bf16w", 552), ("qgemv_stacked_bf16w", 303),
                      ("qgemv_bf16w", 209)):
        rows[key] = Row(key, "qeft_tpu_torch/csrc/qmm.cu", f"qeft_tpu/ops/pallas_qmm.py:{line}",
                        False)
        rows[key].d["per"] = "the four Llama-2-7B stage shapes at M = 1 (QEFT_GEMV_F32W=0)"
    _bf16w_stages(cfg, params, bw, rows)
    n, steps = cfg.num_layers, ABLATION_GEN - 1
    for label, extra, key, per in (("f32w=0 generate", {}, "qgemv_stacked_fused_bf16w", 4),
                                   ("f32w=0 unfused-decode generate",
                                    {"QEFT_FUSED_DECODE": "0"}, "qgemv_stacked_bf16w", 4)):
        with environ(QEFT_GEMV_F32W="0", **extra):
            cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")
            with counted(label) as c:
                gen_toks, _ = generate(params, prompt, cache, cfg, ABLATION_GEN, api=api,
                                       device="cuda")
        want = {key: per * n * steps, "qgemm": 4 * n, "flash_window_attention": n,
                "decode_attention": n * steps}
        same = int((gen_toks == toks).sum())
        log(f"[ablations] {label}: launches {c.counts}; expected {want}; tokens equal to the "
            f"default path's {same}/{ABLATION_GEN}")
        if c.counts != want:
            raise AssertionError(f"{label}: did not launch each kernel as expected")
    # one trace of graph-replayed decode steps
    cache = api.init_cache(cfg, 1, CACHE, dtype=torch.bfloat16, device="cuda")
    with torch.inference_mode():
        logits, cache = api.prefill(params, prompt, cache, cfg)
        buf = torch.zeros(1, 8, dtype=torch.int64, device="cuda")
        buf[:, 0] = logits[:, -1].argmax(-1)
        loop = DecodeLoop(api, params, cache, cfg, buf, PROMPT, SampleConfig(), None)
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            loop.step()
        graph = loop.capture(stream)
        with tempfile.TemporaryDirectory() as logdir:
            with profile_trace(logdir) as prof:
                graph.replay(4)
            trace = os.path.getsize(os.path.join(logdir, "trace.json"))
    names = [e.key for e in prof.key_averages()
             if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    k1 = [nm for nm in names if "qgemv_mma_kernel" in nm]
    log(f"[ablations] profile_trace of 4 graph replays: a {trace}-byte Chrome trace, "
        f"{len(names)} CUDA kernel names, K1's among them: {k1[:2]}")
    if not k1:
        raise AssertionError("profile_trace: the trace does not name K1's kernel")
    return out


class _Beside(threading.Thread):
    """A phase of subprocesses only, run in a thread beside the next phase;
    `result` waits for it, re-raises its failure and returns its seconds."""

    def __init__(self, fn, *args):
        super().__init__(name=fn.__name__, daemon=True)
        self.fn, self.args, self.error, self.seconds = fn, args, None, None
        self.start()

    def run(self):
        tick = time.perf_counter()
        try:
            self.fn(*self.args)
        except BaseException as e:  # re-raised in the main thread by result()
            self.error = e
        self.seconds = round(time.perf_counter() - tick, 1)

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of qeft_tpu_torch on one NVIDIA GPU.")
    ap.add_argument("--only", choices=["attention", "matvec", "probes", "deepseek"], default=None,
                    help="run only the device and build phases and the attention kernels (K3, "
                    "K4, K4q, K8, the latent kernel), the matvec kernels (K1, P4, the grouped "
                    "expert matvec) or the probes (P2, P3, P4), for an A/B of those kernels "
                    "against another checkout's; or DeepSeek-V2-Lite's kernels and main path")
    ap.add_argument("--parent", default=None,
                    help="with --only probes: the root of another checkout (the parent "
                    "commit's), whose P2 and P3 are timed beside this one's in the same call")
    ap.add_argument("--outputs", default=None,
                    help="with --only matvec or deepseek: save the decode matvecs' outputs at "
                    "their stage shapes to this file, or, where it exists (another checkout's "
                    "run), hold them equal to it bit for bit")
    args = ap.parse_args(argv)
    if args.parent and args.only != "probes":
        ap.error("--parent goes with --only probes")
    if args.outputs and args.only not in ("matvec", "deepseek"):
        ap.error("--outputs goes with --only matvec or deepseek")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    tick = time.perf_counter()
    seconds = {}

    def timed(fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        name = fn.__name__.removeprefix("phase_")
        seconds[name] = round(time.perf_counter() - start, 1)
        log(f"[time] {name} {seconds[name]} s ({time.perf_counter() - tick:.1f} s in all)")
        return out

    name, smi = timed(phase_device)
    timed(phase_build)
    if args.only:  # one family of kernels alone, no model
        from qeft_tpu_torch.models.llama import LLAMA_PRESETS

        rows, extra = {}, {}
        if args.only == "deepseek":  # a main path runs: its rows carry their launches
            timed(phase_deepseek, copy_rate(), rows, True)
            if args.outputs:
                _outputs_against(args.outputs)
            for key, row in rows.items():
                row.d["launches_by_path"] = {p: c[key] for p, c in PATH_LAUNCHES.items()
                                             if c.get(key)}
                row.d["launches"] = sum(row.d["launches_by_path"].values())
            log(f"[done] {time.perf_counter() - tick:.1f} s; seconds by phase {seconds}")
            print(json.dumps({"deepseek_kernels": [r.d for r in rows.values()]}))
            print(smi)
            return 0
        if args.only == "attention":
            # the profiler's kernels a call stand beside the rows
            extra["kernels_a_call"] = timed(phase_attention_kernels, LLAMA_PRESETS["llama2-7b"],
                                            copy_rate(), rows)
        elif args.only == "probes":
            timed(phase_probes, copy_rate(), rows, args.parent)
        else:
            timed(phase_matvec, copy_rate(), rows)
            if args.outputs:
                _outputs_against(args.outputs)
        log(f"[done] {time.perf_counter() - tick:.1f} s; seconds by phase {seconds}")
        # no main path ran, so the rows carry no launch count
        print(json.dumps({f"{args.only}_kernels": [{k: v for k, v in r.d.items()
                                                    if k != "launches"} for r in rows.values()],
                          **extra}))
        print(smi)
        return 0
    cfg, params, nbytes, bw = timed(phase_model)
    rows = timed(phase_kernels, cfg, params, bw)
    per_call = timed(phase_attention_kernels, cfg, bw, rows)
    if any(len(names) != 1 or not 0 < n <= 1 for names, n in per_call.values()):
        raise AssertionError(f"K4, K4q and K8 must each be one kernel a call: {per_call}")
    timed(phase_serving_kernels, cfg, params, bw, rows)
    timed(phase_probes, bw, rows)
    prompt, tokens, main_res = timed(phase_main, cfg, params, nbytes)
    timed(phase_profile, cfg, params, prompt)
    timed(phase_oracle, cfg, params, prompt, tokens)
    int8 = timed(phase_int8_generate, cfg, params, prompt)
    stacked = timed(phase_stacked_generate, cfg, params, prompt)
    runs = {"llama2-7b bf16": (tokens, main_res["seconds"], False, False),
            "llama2-7b int8": (int8["tokens"], int8["seconds"], True, False)}
    for label, r in stacked.items():
        runs[f"llama2-7b {label}"] = (r["tokens"], r["seconds"], "int8" in label, True)
    timed(phase_graph, cfg, params, prompt, runs, bw, rows)
    timed(phase_engine, cfg, params)
    timed(phase_spec, cfg, params)
    timed(phase_serving_cli)
    timed(phase_train_kernels, cfg, params, bw, rows)
    timed(phase_train_grad, cfg, params)
    timed(phase_train, cfg, params)
    timed(phase_cli, cfg)
    timed(phase_train_oracle, cfg, params)
    timed(phase_import, cfg, params)
    _, cli = timed(phase_parallel, cfg, params, prompt, tokens, int8["tokens"], bw, rows)
    timed(phase_parallel4, cfg, params, prompt, bw, rows, cli)
    timed(phase_tp_train, cfg, bw, rows)
    timed(phase_dryrun, cfg)
    timed(phase_unfused, prompt)
    timed(phase_ablations, cfg, params, prompt, tokens, bw, rows)
    del params  # the Llama model's tensors, before OPT-6.7B is built
    torch.cuda.empty_cache()
    from qeft_tpu_torch.models.opt import OPT_PRESETS

    opt_cfg = OPT_PRESETS["opt-6.7b"]
    opt_params, opt_bytes = timed(phase_opt_model, opt_cfg)
    timed(phase_family_kernels, opt_cfg, opt_params, bw, rows)
    timed(phase_opt, opt_cfg, opt_params, opt_bytes)
    timed(phase_family_train, opt_cfg, opt_params)
    del opt_params
    torch.cuda.empty_cache()
    timed(phase_families, rows)
    timed(phase_deepseek, bw, rows)
    timed(phase_family_cli, opt_cfg)
    timed(phase_quantize)
    # the quantization CLIs are subprocesses on tiny-v2: they run beside the
    # family quantization on the card (time budget; its block times carry
    # their load)
    beside = _Beside(phase_quantize_cli)
    try:
        timed(phase_family_quantize)
    finally:  # no subprocess outlives the run
        seconds["quantize_cli (beside family_quantize)"] = beside.result()
    hf_cli = timed(phase_hf)  # its CLIs run beside stream-equal (subprocesses only)
    try:
        timed(phase_stream_equal)
    finally:
        seconds["hf_cli (beside stream_equal)"] = hf_cli.result()
    timed(phase_stream_70b)
    for key, row in rows.items():
        by_path = {p: c[key] for p, c in PATH_LAUNCHES.items() if c.get(key)}
        row.d["launches_by_path"] = by_path
        row.d["launches"] = sum(by_path.values())
        if not by_path:
            raise AssertionError(f"no main path launched {key}")
    log(f"[done] {time.perf_counter() - tick:.1f} s; seconds by phase {seconds}")
    print(json.dumps({"kernels": [r.d for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
