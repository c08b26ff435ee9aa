#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda``)
and ``nvidia-smi``; imports neither ``jax`` nor the JAX package ``repro``.
Phases, each printed as one JSON line; any failure exits non-zero:

  1. card: name and power limit (``nvidia-smi``), torch/CUDA versions, the
     TF32 flags as torch sets them (untouched: the trainer and the
     evaluation hold fp32 in their own scope, ``device.fp32_exact``, and
     the flags must read the same after every phase);
  2. build: the five kernel sources compiled from
     ``src/repro_torch/kernels/csrc`` into ``build/kernels/`` (one ``nvcc``
     per source, all started together), with ptxas's register, spill and
     wgmma-serialisation lines;
  3. main path: the paper's MNIST setup at published width (MnistCNN,
     582,026 params; 200 clients on the 65/25/10 fleet, 100 per round,
     E=5, B=10, Adam 1e-3, CR=0.3) through ``build_engine(...).run()`` (the
     event-driven ``Scheduler``, ``megastep="fused"`` by default: each run
     reports why no round fused), with ``apodotiko`` (3 rounds),
     ``fedavg`` (1 round), ``apodotiko-topk`` (3 rounds) and ``scaffold``
     (2 rounds; its control variates finite). Every kernel count is
     set to 0 just before each run and read just after; a kernel of the
     run's path that it never launched fails the script (the top-k kernel,
     counted as ``block_topk``: at least once per round, and each
     ``select_topk`` timed). The result
     must be finite, of the model's shapes, with a consistent update store;
     then the mesh plane (``mesh_phase``): four ranks at ``2x2``, child
     processes (``scripts/torch_mesh_child.py``) joined over gloo by a
     ``file://`` rendezvous, all on this one card (NCCL refuses two ranks
     on one device: the card's tensors are staged through the host), each
     running ``apodotiko`` and ``apodotiko-topk`` (3 rounds, stepwise) and
     the megastep config (3 rounds, stepwise then fused) under
     deterministic algorithms: every rank's host traces equal to the 1x1
     runs above; ``apodotiko``'s params within rtol 1e-4 / atol 1e-5 of a
     1x1 run on the card that trains each cohort in two halves and sums
     each aggregate tile by tile as the mesh does (``split_golden``: on
     the card the lane count alone moves Adam's first steps by +-lr),
     and, at the reference mesh test's size, both strategies' params
     within them of the plain 1x1 runs; params equal to rank 0's
     bit for bit, the megastep pair bit-equal with a fused round,
     and per rank ``staleness_agg`` once an aggregation, ``fused_adam``
     once a local step of each cohort's largest budget and the top-k once
     a round of the top-k runs; wall s a round (and the 1x1 runs'), the
     bytes staged through the host and the collectives' ms a round; then,
     in the same four ranks, durable runs at the durability phase's golden
     config (``apodotiko``, 3 rounds, a snapshot every round; rank 0
     alone writes the journal and the snapshots): the golden run, a run
     killed mid-round 2 on every rank and resumed with ``resume_durable``
     in the same group (journal bytes, params, free list, live rows and
     generator bit-equal to the golden run on the same rank, the golden
     params equal to rank 0's, ``staleness_agg`` once a re-executed
     aggregation and ``fused_adam`` once a local step of each re-executed
     cohort's largest budget), and the ``Scheduler``'s database
     checkpoints (``checkpoint_every=1``, 2 rounds, one more checkpoint
     with live rows) resumed at ``2x2`` and, in this process, at ``1x1``
     (round, results, client columns, params and live rows equal to the
     checkpoint's, one aggregate after); snapshot ms and bytes, the
     bytes the snapshots and the checkpoint stage through the host,
     resume ms per rank and the runs' wall; a rank that exits non-zero
     fails the phase;
     then the megastep: the reference's megastep bench config at that
     width (``apodotiko-topk``, 100 a round, CR 1.0, no eval, instances
     never cool, on zero-variability hardware of speeds 1.0 / 1.45 / 1.9),
     5 rounds, run stepwise, fused, fused, stepwise, all under
     deterministic algorithms: at least 3 rounds fused in each fused run,
     host trace, params, free list, booster and generator bit-equal
     across all four, the same launches in each (``block_topk`` and
     ``staleness_agg`` once a round, ``fused_adam`` once a local step),
     wall time a round for each run, bootstrap rounds apart;
     then the profiles, at the same width, 2 rounds a run, at step
     times that place each profile's events inside the run
     (``PROFILE_STEP_TIMES``): each fault profile (``crash-heavy``,
     ``outage-window``, ``lossy-network``) on the Scheduler with the
     ``chaos`` preset's recovery layer, and each fault and traffic profile
     (``steady-churn``, ``diurnal``, ``flash-crowd``, ``trace-demo``, and
     ``trace-demo`` under ``scaffold``) on the ``Controller`` and the
     ``Scheduler`` under deterministic algorithms: chaos traces (with each
     invocation's fault phase) equal, params (and variates) bit-equal;
     every fault run striking in its profile's phases (the recovery runs
     retrying or timing out), every traffic run applying joins and
     leaves, the SCAFFOLD run zeroing departed clients' variate rows;
     ``trace-demo`` fused against stepwise on the megastep config (6
     rounds at 0.5 s a step, its joins and leaves between fused rounds):
     bit-equal, at least 3 rounds fused; and the oracle planes
     (``update_plane="blob"``, ``data_plane="host"``) against the device
     planes: host traces equal, params within 1e-5, the byte counters
     non-zero only on the oracle planes. Each run's wall a round, fault
     counts by phase, traffic joins, leaves, drops and cancellations and
     the megastep fallback reason are printed;
     then durability, at the same width under deterministic algorithms, in
     a temporary directory (``durability_phase``): an ``apodotiko`` run of
     3 rounds with ``durability="journal"`` (a snapshot every round) is
     killed at two journal boundaries (a ``ResultLanded`` mid-round 2 and
     the record after the first round close) and
     resumed with ``resume_durable``, and an ``apodotiko-topk`` run of 2
     rounds once mid-round 2: journal bytes, history, clock, params, free
     list, live rows, generator (and the fleet's booster and score state)
     bit-equal to the golden run, ``staleness_agg`` (and ``block_topk``)
     launched once a re-executed round and ``fused_adam`` once a local
     step of each re-executed cohort's largest budget; the journal's
     overhead against the same run with durability off (informational,
     beside the reference's 5 % CI limit), its records, bytes and fsyncs,
     snapshot ms and bytes, resume ms; a real SIGKILL of
     ``scripts/torch_durable_crash_child.py`` on the card (ProxyCNN, 10
     clients), resumed here bit-equal to an in-process golden run; and
     the ``Controller``'s database checkpoints (``checkpoint_every=1``, 2
     rounds, then ``Controller.resume`` to 3): round, client records,
     results, params and live rows equal to the checkpoint's; and the
     mesh phase's ``2x2`` golden journal record for record equal to the
     ``apodotiko`` golden journal (its genesis digest that of the ``2x2``
     config), its snapshot ms, bytes, resume ms and wall beside 1x1's;
  4. fleet: the control plane at a million clients: ``select_topk(100,
     1.2)`` over a 2^20-slot ``FleetStore`` for five rounds on the card and
     on a CPU copy of the same state; selections and the device booster
     must be identical, and each call on the card one launch of the fused
     top-k kernel. Median ms per call, launches per call, and the
     dirty-slot flush (the host's share of a call) over 20 repetitions,
     whole and split into host packing, host-to-device copies and index
     writes; then the top-k past the kernel's k (the sort route, the
     reference's ``lax.top_k`` route): ``masked_topk`` at k = 4096 on the
     2^20 fleet-shaped scores and ``scored_topk`` at k = 1025 on the fleet
     state, bit-equal to the plain versions on the card and on the CPU,
     one sort a call and no kernel launch, each timed beside its byte
     bound and ``torch.topk`` at the same k;
  5. profile: one more fedavg round, at one local epoch (30 local steps),
     under ``torch.profiler`` (device busy time, idle share, kernel time by
     name, and each per local step; informational, no limit);
  6. reference: small ProxyCNN runs on the card against the same runs on
     the CPU (the kernels' plain versions), on one shared minibatch-index
     table, for ``fedavg``, ``apodotiko``, ``apodotiko-topk``,
     ``apodotiko-hedge`` (hedges firing), ``scaffold``, a fused
     ``apodotiko-topk`` run (5 of 8 rounds fused) and ProxyLSTM on the
     shakespeare proxy (the sweep's cell: SGD 0.5, batch 8): identical
     host trace
     and megastep counters, params within rtol 1e-4 / atol 1e-5 (and
     SCAFFOLD's ``c_global`` within rtol 1e-4 / atol 1e-5 / lr: a variate
     divides a params difference by steps * lr); and the ``Controller``
     poll loop against the ``Scheduler`` on the card: identical host
     trace;
  7. compress: the apodotiko run's update (final minus initial MnistCNN
     params) through three ``compress_update`` calls with the error
     feedback carried, then ``decompress_update``, on the card and on a CPU
     copy: each card round's codes, scales and error equal to the plain
     version run on the card to the bit; codes and scales equal to the
     CPU copy's to the bit, the error and the decompressed update within
     rtol 1e-6 / atol 1e-7 of it; and exactly 3 fused ``compress_q8``
     launches, 1 ``dequantize_q8`` and no ``quantize_q8`` (counts zeroed
     just before the card calls, read just after);
  8. attention: causal ``flash_attention`` at qwen3-1.7b's attention width
     (16 heads of 128; k/v given 16 heads, grouped-query expansion being
     the caller's). Every check is per block of 128 query rows, at
     tol * (the block's rms + |value|), tol 1e-2 for bf16 and fp16 and
     2e-4 for fp32: a causal row's values shrink with its prefix, so the
     limit follows them. At 4,096 tokens, bf16, fp32 and fp16, against
     the plain version; at 1,024 tokens and head dim 96 (run padded to
     128), bf16 and fp32, against the plain version; at 32,768 tokens
     (bf16), whose plain version would need a 64 GiB score matrix, the
     first 4,096 query rows must equal the 4,096-token run to the bit and
     every row must match a plain computation of 1,024 rows at a time;
     each call one launch;
  9. paper models: the paper's other three models at published width
     (FemnistCNN, 6,603,710 params; SpeechCNN, 67,267; ShakespeareLSTM,
     818,402) through ``build_engine(...).run()`` on the paper's IV-A
     settings (``src/repro/configs/paper_*.py``: FEMNIST E=5, B=10, Adam
     1e-3, 1 round; Speech E=5, B=5, Adam 1e-3, 1 round; Shakespeare E=1,
     B=32, SGD 0.8, 1 round), each on 200 clients of the 65/25/10 fleet,
     100 a round, ``apodotiko``, CR 0.3, data at the paper's shapes and
     ``PAPER_DATA_SCALE``: finite params of the model's shapes, the
     paper's count, the round wall, the cohort's largest step budget, and
     the launches (``staleness_agg`` once a round, ``fused_adam`` once a
     local step of each cohort's largest budget for Adam, never for SGD);
 10. sweep: the ``smoke`` preset, ``paper_tables`` at ``SMOKE_SCALE``
     with ``fedavg`` and ``apodotiko`` (all four datasets on their
     proxies), and ``chaos``, ``production_load`` and
     ``dataplane_ablation`` at their own scales (the ablation's 48 rounds
     cut to 24), through ``run_sweep`` on
     the card and on the CPU: no ``error`` row, host columns (rounds,
     invocations, cold starts, cost, simulated time, failures, retries)
     equal, accuracies side by side; the ``smoke`` table under
     deterministic algorithms the same to the byte for one and two
     workers; each host-plane cell of ``dataplane_ablation`` equal to its
     device twin; every row printed;
 11. lm: the dense decoder-LM family at published width. Serving:
     ``DecoderLM`` of qwen3-1.7b (1,720,574,976 params, bf16) initialized
     on the card prefills 4 prompts of 512 tokens into a cache of 576 and
     decodes greedily to fill it, in bf16 and again in fp32; each decoded
     position's logits must be within ``LM_DECODE_RTOL`` (relative L2:
     5e-2 bf16, 1e-3 fp32) of the full forward's at that position;
     prefill ms, decode tokens/s and peak memory. Training:
     ``repro_torch.launch.train.main`` for qwen3-1.7b (not ``--smoke``),
     3 steps of 4 x 1,024 tokens, remat as the config sets it, Adam
     through ``fused_adam``: a finite loss every step, the first batch's
     loss lower after the steps, one ``fused_adam`` launch a step (counts
     zeroed just before, read just after); step ms and peak memory.
     Federated: ``examples/torch_train_fl_lm.py``'s ``--full`` model (12
     layers, d 768, vocab 32,000: 100,094,208 params) and setup through the
     ``Controller``, 12 clients, 3 rounds, on the example's token streams
     over 2,048 tokens (``LM_FL``: its Markov source at 32,000 tokens costs
     ~8.5 minutes of host time): ``staleness_agg`` once an aggregation and
     ``fused_adam`` once a local step of each cohort's largest budget;
     then the example's ``main`` at its container size on the card and on
     the CPU, host traces (selections, invocation records, simulated
     clock, cost, cold starts) equal;
 12. moe: the MoE + MLA LM family. Serving: ``DecoderLM`` of
     DeepSeek-V2-Lite uncut (27 layers, 15,706,484,224 params, bf16: MLA
     attention, an MLA-dense first layer, 64 routed experts top-6 and 2
     shared) prefills 4 x 512 into a cache of 576 and decodes greedily to
     fill it, and Arctic at its published width cut to 1 layer
     (14,069,945,344 params, bf16: GQA, 128 experts top-2 and a parallel
     dense residual FFN; two layers would need 55.4 GB of weights) 4 x 128
     into 160; each timed at the published capacity factor (init s,
     prefill ms first and second, decode tokens/s and ms a step, peak GB),
     then checked on the same params at ``ceil(n_experts / top_k)`` (11
     and 64), where every call's capacity holds all its tokens (asserted):
     each decoded position's logits within ``LM_DECODE_RTOL`` (5e-2) of
     the full forward's, which holds MLA's absorbed branch (prefill and
     decode) against its expanded one (the full forward); the same check
     in fp32 at DeepSeek's 3-layer cut, within 1e-3. Training, at
     DeepSeek's 3-layer cut (1,670,135,296 params; all 27 layers' fused
     Adam rows would be ~375 GB): ``launch.train.main --layers 3``, 3
     steps of 4 x 1,024 tokens through ``fused_adam`` (a finite loss a
     step, the first batch's lower after, exactly 3 launches), then 3
     steps of ``launch.train.train_step`` with
     ``build_optimizer("adafactor", 1e-3)`` (``MOE_ADAFACTOR_LR``: at
     Arctic's 1e-2 the reference's formula diverges at this width; the
     same loss checks, no kernel launch); step ms and peak GB. Arctic's ``launch.train --smoke``
     (Adafactor, its config's optimizer) on the card and on the CPU, each
     loss within 1e-4 relative. Federated:
     ``examples/torch_train_fl_lm.py --arch deepseek-v2-lite-16b`` at its
     container size through the ``Controller``, 12 clients, 3 rounds:
     ``staleness_agg`` once an aggregation, ``fused_adam`` once a local step
     of each cohort's largest budget, then the host trace and the host's
     metrics card against CPU;
 13. ssm: the SSM and hybrid LM families. Serving: ``DecoderLM`` of
     Mamba2-370M uncut (48 layers, 368,338,432 params) and Zamba2-2.7B
     uncut (54 layers, 2,435,782,560 params: 9 chunks of 6 Mamba2 layers,
     each followed by the shared attention block) in bf16 prefill 4 x 512
     into a cache of 576 and decode greedily to fill it (init s, prefill ms
     first and second, decode ms a step and tokens/s, init and run peak
     GB); each decoded position's logits within ``SSM_DECODE_RTOL`` (0.15
     in bf16: the reference's own bf16 decode strays ~9 % at these depths,
     past ``LM_DECODE_RTOL``'s 5 %) of the full forward's, which holds the
     recurrent decode step and the prefill's state handoff against the
     chunked scan; the same check in fp32 (1e-3) for Mamba2 uncut and
     Zamba2 cut to 12 layers. Mamba2 at prefill_32k's length, its batch
     cut to 1: 32,768 tokens prefilled into 32,776, 7 decode steps, the
     full forward over 32,775 (scan chunk 115, 285 chunks; the prefill 128
     of 256) within 0.15 (only Mamba2: Zamba2's einsum attention would
     hold [B, 32, S, S] fp32 logits).
     Training: ``launch.train.main`` for Mamba2 uncut, 3 steps of 4 x 4,096
     tokens (train_4k's length, its batch cut to 4), and for Zamba2 cut to
     36 layers (1,717,794,240 params; all 54 would need ~70 GB of Adam
     state), 3 steps of 4 x 1,024: each loss finite, the first batch's
     loss lower after, exactly 3 ``fused_adam`` launches; step ms and peak
     GB. Both archs' ``launch.train --smoke`` card against CPU, each loss
     within 1e-4 relative. Federated: ``examples/torch_train_fl_lm.py
     --arch mamba2-370m`` and ``--arch zamba2-2.7b`` at its container size
     through the ``Controller``, 12 clients, 3 rounds: ``staleness_agg``
     once an aggregation, ``fused_adam`` once a local step of each
     cohort's largest budget, then the host trace and the host's metrics
     card against CPU;
 14. xattn: the VLM and enc-dec LM families. Serving: ``DecoderLM`` of
     Llama-3.2-Vision uncut (32 self layers in 8 chunks, each after one
     gated cross-attention block: 9,775,157,256 params) over random
     patches at all 1,601 positions, its gates set to 1.0 after init
     (drawn as zeros, they would hide cross attention from the check),
     and ``EncDecLM`` of SeamlessM4T-large-v2 uncut (24 encoder and 24
     decoder layers, 2,034,784,256 params) over 4 x 512 random frames, in
     bf16, prefill 4 x 512 into a cache of 576 (the cross K/V over the
     patches or the encoded frames computed once, in the cache) and decode
     greedily to fill it (init s, prefill ms first and second, decode ms a
     step and tokens/s, init and run peak GB); each decoded position's
     logits within ``LM_DECODE_RTOL`` of the full forward's over the same
     patches or frames; the same check in fp32 (1e-3) for the VLM cut to 8
     layers and SeamlessM4T uncut. Training: ``launch.train.main`` for the
     VLM cut to 4 layers (2,141,237,249 params) and SeamlessM4T uncut, 3
     steps of 4 x 1,024 tokens each (the reference's batches: zero
     patches, normal frames): each loss finite, the first batch's loss
     lower after, exactly 3 ``fused_adam`` launches; step ms and peak GB.
     Both archs' ``launch.train --smoke`` card against CPU, each loss
     within 1e-4 relative. Under the zero patches and the drawn zero
     gates the VLM's cross attention takes no grad, so its smoke config
     is also trained 3 steps through ``launch.train.train_step`` with
     its gates at 1.0 over normal patches, card against CPU from one
     init: each loss, and each cross-attention leaf's Adam moments
     (relative L2), within 1e-4; each leaf moved. Neither is federated:
     the reference's client adapter passes tokens alone;
 15. launch: the launch tooling (``repro_torch.launch``). Cells executed
     on the card's 1x1 mesh (``dryrun.execute_cell``),
     qwen3-1.7b uncut: ``train_4k`` at 1 x 4,096 (remat on; its batch cut
     from 256), ``prefill_32k`` at 1 x 8,192 (cut from 32 x 32,768: fp32
     logits would be 68.7 GB a layer), ``decode_32k`` at 4 sequences
     against the 32,768-token cache (cut from 128: the step holds the
     caches, each layer's new copy and their stack, 3 x 15 GB), ``fl_round`` at K = 8
     (cut from 32), and mamba2-370m ``long_500k`` uncut: each run's
     counted FLOPs equal to its meta trace's, every output finite, the
     train step one ``fused_adam`` launch, the aggregate within one bf16
     ulp of an fp64 weighted sum plus the fp32 summation's error bound
     (where the terms cancel, that error is many ulps of the small sum);
     a line each with time, peak GB, FLOPs,
     bytes, model FLOPs, the bound and MFU. The four kinds at qwen3's
     smoke config card against CPU within 1e-5 relative L2; ``momentum``'s
     cohort step on [128, 582,656], lanes masked, card against CPU.
     Last, the dry run's meta sweep on the abstract 16x16 mesh, every
     arch x shape cell (``--cost-mode auto``: ssm and hybrid extrapolated
     from two depths, the rest traced at full depth on ``meta`` tensors)
     in three child processes that see no card, started after the mesh
     phase and running beside the card's phases (one thread each, to
     keep the script inside its time limit on slow hosts): zero errors, the skips exactly the reference's (``long_500k``
     of every arch but Mamba2 and Zamba2);
 16. kernels: each kernel at the shapes its path gave it, against its
     plain torch version on the same inputs (rtol 1e-5 / atol 1e-6;
     the top-k entries and the quant8 kernels exactly; attention by its
     phase's check), and timed (median of CUDA-event times) beside the
     plain version, one PyTorch library call where one computes the same
     function (``dequantize_q8``: ``torch.mul``, held to the bit;
     attention: ``scaled_dot_product_attention``; ``quantize_q8`` and
     ``compress_q8`` have none: ``compress_q8``, at the compress phase's
     update with its error feedback carried, is timed beside the stepwise
     path it replaces, event and device time), and the bound: the larger
     of bytes / HBM rate and operations / the peak rate of their type
     (fp32; the 16-bit tensor rate for bf16 and fp16 attention; for fp32
     attention, three TF32 products a product at the TF32 tensor rate,
     with the fp32 FMA time beside it). Attention has an entry per input
     type at 4,096 tokens (bf16 and fp16: the wgmma/TMA kernel; fp32: the
     kernel of three TF32 mma.sync products) and the bf16 one at 32,768,
     each with its achieved TFLOP/s. ``staleness_agg`` has two, the sweep
     form at the ``fedavg`` round's shape and the rows form at the
     ``apodotiko`` round's, each with two calls bit-equal, its column split
     on this card (``ctas``, ``pieces_per_cta``, ``piece_bytes_max``), the
     event time warm (``ms``) and with the L2 flushed before each call by
     256 MB of scratch written and read back outside the events
     (``flushed_ms``), the
     kernel's own profiler time both ways (``device_ms``,
     ``flushed_device_ms``), and ``bound_share``, the bound over the
     flushed device time. Top-k has four: ``block_topk`` (the
     one-launch ``masked_topk`` on seeded scores at M = 256) and
     ``block_topk[fleet]`` (at 2^20), each beside ``torch.topk``;
     ``scored_topk`` (the fused selection step at the ``apodotiko-topk``
     run's own state, M = 256, k = 100, beta 1.2: the main path's call)
     and ``scored_topk[fleet]`` (at the fleet phase's state), each beside
     the stepwise torch composition. ``fused_adam`` has three, at the
     MNIST run's width, at FemnistCNN's (``fused_adam[femnist]``, [128,
     6,603,776]) and at SpeechCNN's (``fused_adam[speech]``), from those
     runs, each with its device time; ``staleness_agg[femnist]``,
     ``[speech]`` and ``[shakespeare]`` are the rows form at each paper
     run's own width and last K; ``staleness_agg[pytree]`` is the blob
     plane's launch (``ops.aggregate_pytree``) over K MnistCNN-shaped
     trees, K the plane run's last pending count, the stack timed apart.
     The lm phase's entries, timed right after it while the card holds
     nothing else: ``fused_adam[qwen3-1.7b]`` (the centralized step, one
     lane of 1,720,574,976, its check against the plain version a chunk
     of columns at a time), ``fused_adam[fl_lm]`` (the federated run's
     largest cohort at W = 100,094,208) and ``staleness_agg[fl_lm]`` at
     its last aggregate, in the route it took, and in the rows form.
     The moe phase's entry: ``fused_adam[deepseek-v2-lite-16b]`` (the
     centralized step at the 3-layer cut, one lane of 1,670,135,296); the
     ssm phase's: ``fused_adam[mamba2-370m]`` (the centralized Mamba2
     step, one lane of 368,338,432); the xattn phase's:
     ``fused_adam[llama-3.2-vision-11b]`` and
     ``fused_adam[seamless-m4t-large-v2]`` (each centralized step, one lane
     of 2,141,237,249 and of 2,034,784,256). The mesh phase's:
     ``staleness_agg[mesh]``, the sweep form at a rank's tile ``[C/2,
     W/2]`` of the ``apodotiko`` run's store. Every ``fused_adam`` entry
     times its plain version 2^29 columns at a time, the pieces' times
     summed: at 2.1 B columns its temporaries would not fit beside its
     inputs.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path
from typing import Optional

# deterministic algorithms (the megastep phase) need a fixed cuBLAS
# workspace, set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM data sheet, dense bf16 (and fp16) tensor cores
TF32_FLOP_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
TF32_PRODUCTS = 3             # TF32 products per fp32 product (hi/lo split)
L2_FLUSH_BYTES = 256 << 20   # scratch written and read between flushed reps
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
SEED = 0
# the paper's MNIST data at its published shapes (the main path's)
MAIN_DATA = dict(name="mnist", n_clients=200, scale=1.0, seed=SEED,
                 fidelity="paper")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


class NumpyBatchIndices:
    """Minibatch indices from a numpy generator, identical on every device:
    the card run and the CPU run of the reference phase share the table."""

    def __init__(self, seed: int, batch_size: int):
        self.rng = np.random.default_rng(seed)
        self.batch_size = batch_size

    def __call__(self, Kp, max_steps, n_i):
        n = np.maximum(n_i.cpu().numpy(), 1)[:, None, None]
        u = self.rng.random((Kp, max_steps, self.batch_size))
        return torch.as_tensor((u * n).astype(np.int64), device=n_i.device)


def time_ms(fn, reps: int = 20, warmup: int = 3, before=None) -> float:
    """Median of per-call CUDA-event times, in ms; ``before`` (if given)
    runs ahead of each call, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(calls: dict, reps: int = 10) -> dict:
    """Median device time, by kernel name, of the kernels whose name holds
    each key of ``calls`` over ``reps`` calls of its function, all in one
    ``torch.profiler`` session (device activity only): the kernel's own
    time, without the host work of its wrapper, which a CUDA-event time of
    one short call includes. None for a name the profiler did not see, and
    the kernel names it did see on stderr: this time is informational and
    not validated (a session may miss a kernel or read one under its
    bound); the contract's ``ms`` is the event time."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name in calls:
        times = [(e.time_range.end - e.time_range.start) / 1e3
                 for e in events if name in e.name]
        out[name] = statistics.median(times) if times else None
    missing = [name for name, ms in out.items() if ms is None]
    if missing:
        seen = sorted({e.name[:60] for e in events})[:8]
        print(f"chip_smoke: the profiler saw no {missing} in {len(events)} "
              f"device events ({seen})", file=sys.stderr, flush=True)
    return out


def device_total_ms(fn, reps: int = 10):
    """Device time of one call of ``fn``, all its kernels together: the sum
    of every device activity over ``reps`` calls in one ``torch.profiler``
    session, divided by ``reps``. None where the profiler saw nothing."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(spans) / reps if spans else None


def l2_flush(dev):
    """A function that writes ``L2_FLUSH_BYTES`` of scratch on ``dev``,
    several times the card's 50 MB L2, then reads it back: after it, a
    kernel finds none of its inputs in the L2, as a caller that last
    touched them a round ago does, and no dirty line of the scratch that
    the kernel would have to write back to make room."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    return lambda: scratch.fill_(1.0).sum()


def put_device_ms(entry: dict, key: str, ms) -> None:
    entry[key] = ms
    if ms is None:
        entry[f"{key}_note"] = "the profiler saw no such kernel"


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tf32_flags() -> tuple:
    """(cudnn.allow_tf32, cuda.matmul.allow_tf32), as the process has them."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def zero_counts() -> None:
    from repro_torch.kernels import wrappers
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import launch_counts
    return launch_counts()


def path_kernels(strategy: str, optimizer: str = "adam") -> tuple:
    """The kernels a run of ``strategy`` must launch (``fused_adam`` only
    where the clients train with Adam)."""
    base = ("staleness_agg",) + (("fused_adam",) if optimizer == "adam"
                                 else ())
    return base + ("block_topk",) if strategy == "apodotiko-topk" else base


def host_trace(engine):
    hist = [(l.round, l.t_start, l.t_end, l.n_aggregated, l.n_stale)
            for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


def step_budget(data, cid: int, batch_size: int, local_epochs: int) -> int:
    """A client's local steps: ceil(n / B) * E, at least 1."""
    return max(-(-int(data.n[cid]) // batch_size) * local_epochs, 1)


def same(a, b) -> bool:
    """Deep equality, tensors by value (bits where the caller viewed them
    as integers)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# ---------------------------------------------------------------- main path
def paper_kw(strategy: str, rounds: int, **over) -> dict:
    """``paper_cfg``'s fields."""
    kw = dict(n_clients=200, clients_per_round=100, rounds=rounds,
              strategy=strategy, concurrency_ratio=0.3, local_epochs=5,
              batch_size=10, optimizer="adam", lr=1e-3, seed=SEED)
    return {**kw, **over}


def paper_cfg(strategy: str, rounds: int, **over):
    """The paper's MNIST setup (IV-A): 200 clients, 100 per round, E=5,
    B=10, Adam 1e-3, CR=0.3; ``over`` sets other fields."""
    from repro_torch.core.services import FLConfig

    return FLConfig(**paper_kw(strategy, rounds, **over))


def paper_engine(strategy: str, rounds: int, data, dev, **over):
    """``paper_cfg`` at published width (MnistCNN on the 65/25/10 fleet)
    through ``build_engine`` (the Scheduler). Only the number of rounds is
    cut (and what ``over`` sets)."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import MnistCNN

    return build_engine(paper_cfg(strategy, rounds, **over), MnistCNN(),
                        data, list(paper_fleet(200)), device=dev)


def run_main_path(strategy: str, rounds: int, data, dev):
    """One paper-width run with every kernel count zeroed just before and
    read just after. Returns (engine, record)."""
    from repro_torch.core import aggregation
    from repro_torch.models.paper_models import MnistCNN

    ctl = paper_engine(strategy, rounds, data, dev)
    rounds_log = []
    clock = [time.perf_counter()]

    def progress(log):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rounds_log.append({
            "round": log.round, "wall_s": now - clock[0],
            "accuracy": log.accuracy, "n_aggregated": log.n_aggregated,
            "n_stale": log.n_stale, "store_capacity": ctl.store.capacity,
            "agg_route": aggregation.last_path()})
        clock[0] = now

    # each selection's wall time on the card (the dirty flush, the fused
    # selection launch and the copy of the cohort to the host), queued
    # work drained before it starts
    select_ms = []
    select_topk = ctl.db.fleet.select_topk

    def timed_select_topk(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = select_topk(*args, **kwargs)
        torch.cuda.synchronize()
        select_ms.append((time.perf_counter() - t) * 1e3)
        return out

    ctl.db.fleet.select_topk = timed_select_topk
    guard0 = aggregation.guard_recomputes()
    zero_counts()
    clock[0] = time.perf_counter()
    metrics = ctl.run(progress=progress)
    torch.cuda.synchronize()
    launches = read_counts()
    cohorts = collections.Counter(r.round for r in ctl.platform.invocations)
    record = {"strategy": strategy, "engine": metrics["engine"],
              "rounds": rounds_log,
              "cohort_sizes": [cohorts[r] for r in sorted(cohorts)],
              "largest_step_budget": max(
                  step_budget(data, r.client_id, ctl.cfg.batch_size,
                              ctl.cfg.local_epochs)
                  for r in ctl.platform.invocations),
              "launches": launches, "select_topk_ms": select_ms,
              "last_path": aggregation.last_path(),
              "guard_recomputes": aggregation.guard_recomputes() - guard0,
              "final_accuracy": metrics["final_accuracy"],
              "total_sim_time_s": metrics["total_time"],
              "megastep": metrics["megastep"],
              "megastep_rounds": metrics["megastep_rounds"],
              "megastep_fallback_reason": metrics["megastep_fallback_reason"],
              "n_params": ctl.spec.n_params,
              "row_width": ctl.store.row_width}
    emit("main_path", **record)

    # what comes out is right: the model's shapes, finite values, a
    # consistent update store, every kernel of the path launched
    if metrics["engine"] != "scheduler":
        raise AssertionError(f"build_engine ran {metrics['engine']}")
    if metrics["megastep_rounds"]:
        raise AssertionError(f"{strategy}: a round fused under a progress "
                             "callback")
    if ctl.spec.n_params != 582_026:
        raise AssertionError(f"MnistCNN has {ctl.spec.n_params} params")
    if len(ctl.history) != rounds:
        raise AssertionError(f"{len(ctl.history)} of {rounds} rounds ran")
    template = MnistCNN().init(torch.Generator().manual_seed(0))
    for name, leaf in ctl.params.items():
        if tuple(leaf.shape) != tuple(template[name].shape):
            raise AssertionError(f"{name}: shape {tuple(leaf.shape)}")
        if leaf.device.type != "cuda" or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: not finite on the card")
    if not all(0.0 <= r["accuracy"] <= 1.0 for r in rounds_log):
        raise AssertionError("accuracy out of [0, 1]")
    if ctl.c_global is not None and (
            tuple(ctl.c_global.shape) != (ctl.store.row_width,)
            or not bool(torch.isfinite(ctl.c_global).all())
            or not bool(torch.isfinite(ctl.c_buf).all())):
        raise AssertionError(f"{strategy}: control variates malformed")
    pending = {r.update_row for r in ctl.db.results if not r.aggregated}
    live = set(map(int, ctl.store.live_rows()))
    if not pending <= live:
        raise AssertionError("a pending result lost its update row")
    for name in path_kernels(strategy):
        if launches[name] <= 0:
            raise AssertionError(f"{strategy}: {name} was never launched")
    if "block_topk" in path_kernels(strategy) and \
            min(launches["block_topk"], len(select_ms)) < rounds:
        raise AssertionError(f"{strategy}: block_topk launched "
                             f"{launches['block_topk']} times in "
                             f"{len(select_ms)} selections, {rounds} rounds")
    return ctl, record


# ----------------------------------------------------------------- megastep
# rounds in all (6 until the mesh phase: cut to keep the script under
# 1,000 s; 3 still fuse) and the stepwise bootstrap ones
MEGA_ROUNDS, MEGA_BOOT = 5, 2
MEGA_SPEEDS = (1.0, 1.45, 1.9)       # benchmarks/bench_round.py's hardware


def det_fleet(n: int) -> list:
    """Zero-variability hardware (``benchmarks/bench_round.py``'s megastep
    fleet): invocation durations are pure functions of profile and steps,
    the precondition of the megastep's eligibility proof."""
    from repro_torch.faas.hardware import HardwareProfile
    return [HardwareProfile(f"det{i % 3}", speed=MEGA_SPEEDS[i % 3],
                            vcpus=1.0, mem_gib=2.0, variability=0.0)
            for i in range(n)]


def megastep_cfg(**over) -> dict:
    """The reference's megastep bench config (``bench_round.py``: top-k
    selection, CR 1.0, no eval, instances never cool) at the paper's MNIST
    width: 200 clients, 100 a round, E=5, B=10, Adam 1e-3."""
    cfg = dict(n_clients=200, clients_per_round=100, rounds=MEGA_ROUNDS,
               strategy="apodotiko-topk", concurrency_ratio=1.0,
               local_epochs=5, batch_size=10, optimizer="adam", lr=1e-3,
               eval_every=0, keep_warm=1e9, seed=SEED)
    cfg.update(over)
    return cfg


MEGA_ORDER = ("stepwise", "fused", "fused", "stepwise")   # ABBA


def megastep_phase(data, dev, model=None, boot: int = MEGA_BOOT,
                   order: tuple = MEGA_ORDER, emit_as: str = "megastep",
                   **cfg_over) -> dict:
    """The fused-round megastep at paper width: the same run (``megastep_cfg``,
    MnistCNN unless ``model`` is given) once per entry of ``order``, the
    modes alternated so that neither gains from running later, all under
    ``torch.use_deterministic_algorithms(True)`` (restored after). Each run
    is two segments, the ``boot`` stepwise bootstrap rounds (every client
    invoked once) and then the rest, each timed on the host clock with the
    card drained, its kernel counts zeroed just before and read just after.
    The phase fails unless every fused run fused at least 3 rounds, every
    run's host trace, params, free list, device booster and generator equal
    the first stepwise run's bit for bit, and every run launched
    ``block_topk`` and ``staleness_agg`` once a round and ``fused_adam``
    once a local step (the cohort's largest step budget a round)."""
    from repro_torch.core.aggregation import rows_dispatch
    from repro_torch.core.scheduler import build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.models.paper_models import MnistCNN

    kw = megastep_cfg(**cfg_over)
    rounds, n_steady = kw["rounds"], kw["rounds"] - boot
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for mode in order:
            eng = build_engine(
                FLConfig(**{**kw, "rounds": boot, "megastep": mode}),
                model or MnistCNN(), data, det_fleet(kw["n_clients"]),
                device=dev)
            segs = []
            for upto in (boot, rounds):
                eng.cfg.rounds = upto
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = eng.run()
                torch.cuda.synchronize()
                segs.append((time.perf_counter() - t0, read_counts()))
            runs.append((mode, eng, m, segs))
    finally:
        torch.use_deterministic_algorithms(was)

    # the launches a round must make: one selection, one aggregate, one
    # Adam step per local step of the cohort's largest budget
    first = runs[0][1]
    per_round = collections.defaultdict(int)
    for r in first.platform.invocations:
        per_round[r.round] = max(per_round[r.round], step_budget(
            data, r.client_id, kw["batch_size"], kw["local_epochs"]))
    want = {"block_topk": rounds, "staleness_agg": rounds,
            "fused_adam": sum(per_round.values())}

    def state(eng):
        eng.db.fleet._flush_device()
        return {"trace": host_trace(eng), "free_list": list(eng.store._free),
                "booster": eng.db.fleet._dev.booster.cpu().view(torch.int32),
                "generator": eng.trainer.generator.get_state().cpu(),
                "params": {n: p.view(torch.int32)
                           for n, p in eng.params.items()}}

    ref_state = state(first)
    report, equal = [], {}
    for i, (mode, eng, m, segs) in enumerate(runs):
        got = state(eng)
        equal[f"{i}:{mode}"] = {k: same(v, ref_state[k])
                                for k, v in got.items()}
        report.append({
            "mode": mode, "megastep_rounds": m["megastep_rounds"],
            "megastep_scans": m["megastep_scans"],
            "megastep_fallback_reason": m["megastep_fallback_reason"],
            **{k: m[k] for k in TRAFFIC_KEYS},
            "bootstrap_wall_s_per_round": segs[0][0] / boot,
            "wall_s_per_round": segs[1][0] / n_steady,
            "launches": {k: sum(c[k] for _, c in segs) for k in want}})
    walls = {mode: [r["wall_s_per_round"] for r in report
                    if r["mode"] == mode] for mode in set(order)}
    record = {
        "config": {k: kw[k] for k in ("n_clients", "clients_per_round",
                                      "rounds", "strategy",
                                      "concurrency_ratio", "local_epochs",
                                      "batch_size", "eval_every",
                                      "keep_warm")},
        "speeds": list(MEGA_SPEEDS), "n_params": first.spec.n_params,
        "deterministic_algorithms": True, "bootstrap_rounds": boot,
        "order": list(order), "runs": report,
        "agg_route": "gather" if rows_dispatch(
            first.store.capacity, kw["clients_per_round"]) else "sweep",
        "store_capacity": first.store.capacity,
        "wall_s_per_round": walls,
        "fused_over_stepwise": (statistics.mean(walls["fused"])
                                / statistics.mean(walls["stepwise"])),
        "launches_wanted": want,
        "launches_per_round": {k: v / rounds for k, v in want.items()},
        "bit_equal": equal}
    emit(emit_as, **record)
    for r in report:
        fused = r["mode"] == "fused"
        if fused and r["megastep_rounds"] < min(3, n_steady) or \
                not fused and r["megastep_rounds"]:
            raise AssertionError(f"a {r['mode']} run fused "
                                 f"{r['megastep_rounds']} rounds: "
                                 f"{r['megastep_fallback_reason']}")
        if r["launches"] != want:
            raise AssertionError(f"a {r['mode']} run launched "
                                 f"{r['launches']}, want {want}")
    if not all(all(e.values()) for e in equal.values()):
        raise AssertionError(f"fused differs from stepwise: {equal}")
    return record


def straggler_fleet(n: int) -> list:
    """The sweep's "straggler" hardware mix (75% 1vCPU, 25% GPU), as the
    reference's hedging presets use it."""
    from repro_torch.faas.hardware import HARDWARE_PROFILES
    rng = np.random.default_rng(0)
    n_slow = round(n * 0.75)
    fleet = ([HARDWARE_PROFILES["cpu1"]] * n_slow
             + [HARDWARE_PROFILES["gpu"]] * (n - n_slow))
    rng.shuffle(fleet)
    return fleet


# --------------------------------------------------------------------- mesh
MESH_SPEC, MESH_WORLD = "2x2", 4      # four ranks over gloo on one card
MESH_ROUNDS = 3                       # each run but the megastep pair's
MESH_MEGA_ROUNDS = 3                  # megastep_cfg: 2 bootstrap + 1 fused
MESH_STRATEGIES = ("apodotiko", "apodotiko-topk")
# the wide run held to split_golden: one keeps the phase under 90 s (each
# split run costs ~9 s); the others run the same mesh code at that width
MESH_SPLIT_STRATEGY = "apodotiko"
# the held config: tests/test_mesh_plane.py's size (ProxyCNN, 10 clients,
# 4 a round, E=1, B=5), where the card's lane split does not flip Adam's
# steps (see mesh_phase)
MESH_HELD = dict(n_clients=10, clients_per_round=4, local_epochs=1,
                 batch_size=5)
MESH_HELD_DATA = dict(name="mnist", n_clients=10, scale=0.05, seed=SEED)
MESH_TIMEOUT_S = 360.0
# the durable runs at MESH_SPEC (the durability phase's golden config):
# the golden run, one crash point of ``crash_points`` resumed, and the
# Scheduler's database checkpoints resumed at MESH_SPEC and at 1x1
MESH_DUR_STRATEGY = "apodotiko"
MESH_DUR_CRASH = "mid_round_2"
MESH_CHILD_ARGV = [sys.executable, str(ROOT / "scripts" /
                                        "torch_mesh_child.py")]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_runs(data_kw: dict, model: str, cfg_over: dict,
              mega_over: dict) -> list:
    """The phase's runs, as each rank runs them, stepwise unless named:
    ``MESH_STRATEGIES`` at ``paper_kw`` on ``data_kw`` / ``model`` (the
    main path's runs) and at ``MESH_HELD`` (``held_*``), each timed a
    round; ``megastep_cfg`` stepwise then fused, timed whole."""
    wide = dict(data=data_kw, model=model, fleet="paper", per_round=True)
    held = dict(data=MESH_HELD_DATA, model="ProxyCNN", fleet="paper",
                per_round=True)
    runs = [dict(wide, name=s, cfg=paper_kw(s, MESH_ROUNDS,
                                            megastep="stepwise", **cfg_over))
            for s in MESH_STRATEGIES]
    runs += [dict(held, name=f"held_{s}", cfg=paper_kw(
        s, MESH_ROUNDS, megastep="stepwise", **MESH_HELD))
        for s in MESH_STRATEGIES]
    runs += [dict(data=data_kw, model=model, fleet="det", per_round=False,
                  name=f"megastep_{mode}",
                  cfg=megastep_cfg(**{"rounds": MESH_MEGA_ROUNDS,
                                      **mega_over}, megastep=mode))
             for mode in ("stepwise", "fused")]
    return runs


def held_golden(dev) -> dict:
    """The held config's 1x1 runs on ``dev``."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.proxy_models import ProxyCNN

    data = make_federated_dataset(**MESH_HELD_DATA)
    out = {}
    for s in MESH_STRATEGIES:
        cfg = paper_cfg(s, MESH_ROUNDS, megastep="stepwise", **MESH_HELD)
        eng = build_engine(cfg, ProxyCNN(10), data,
                           list(paper_fleet(cfg.n_clients)), device=dev)
        eng.run()
        out[f"held_{s}"] = eng
    return out


def mesh_model(name: str):
    """The phase's models by name, as the ranks build them."""
    from repro_torch.models.paper_models import MnistCNN
    from repro_torch.models.proxy_models import ProxyCNN
    return {"MnistCNN": MnistCNN, "ProxyCNN": lambda: ProxyCNN(10)}[name]()


def split_lanes(trainer, d: int) -> None:
    """Make the un-meshed ``trainer`` train each cohort as a data axis of
    ``d`` splits it: the whole index table drawn once (the generator moves
    as at 1x1), then ``d`` calls of Kp/d lanes, each with its rows of the
    table and the whole cohort's step maximum; rows, losses and variates
    joined in lane order."""
    train, draw = trainer._train_lanes, trainer.batch_indices

    def split(global_params, store, sel_t, n_t, steps_t, max_steps, W,
              c_global=None, c_lanes=None):
        table = draw(sel_t.shape[0], max_steps, n_t)
        share = sel_t.shape[0] // d
        outs = []
        try:
            for lo in range(0, sel_t.shape[0], share):
                sl = slice(lo, lo + share)
                trainer.batch_indices = lambda *a, part=table[sl]: part
                outs.append(train(
                    global_params, store, sel_t[sl], n_t[sl], steps_t[sl],
                    max_steps, W, c_global,
                    None if c_lanes is None else c_lanes[sl]))
        finally:
            trainer.batch_indices = draw
        flat, loss, ci = zip(*outs)
        return (torch.cat(flat), torch.cat(loss),
                None if ci[0] is None else torch.cat(ci))

    trainer._train_lanes = split


@contextlib.contextmanager
def split_sums(d: int, m: int):
    """Within the block, ``ops.aggregate_rows`` (and its exact-rows form)
    sums a whole 1x1 buffer as a ``d x m`` mesh sums its tiles: for each
    data rank ``i`` and model rank ``j``, the sweep over rows ``i::d`` and
    column stripe ``j`` (a contiguous copy, as a rank's tile is) with the
    weights of those rows; the data ranks' partials added in rank order,
    the stripes joined."""
    from repro_torch.kernels import ops

    sweep, gather = ops.aggregate_rows, ops.aggregate_rows_gather

    def split(buffer, row_idx, weights):
        idx = np.asarray(row_idx, np.int64)
        w = np.asarray(weights, np.float32)
        wt = buffer.shape[1] // m
        stripes = []
        for j in range(m):
            part = None
            for i in range(d):
                mine = idx % d == i
                p = sweep(buffer[i::d, j * wt:(j + 1) * wt].contiguous(),
                          idx[mine] // d, w[mine])
                part = p if part is None else part + p
            stripes.append(part)
        return torch.cat(stripes)

    ops.aggregate_rows = ops.aggregate_rows_gather = split
    try:
        yield
    finally:
        ops.aggregate_rows, ops.aggregate_rows_gather = sweep, gather


def split_golden(dev, data, model: str, cfg_over: dict) -> dict:
    """The wide runs' params reference: ``MESH_SPLIT_STRATEGY`` at
    ``paper_kw`` (stepwise, as the ranks run it) at 1x1 on ``dev`` under
    deterministic algorithms, its cohorts trained as ``split_lanes``
    splits them and its aggregates summed as ``split_sums`` sums them.
    It shares the mesh's lane split and sum order, and none of its code:
    the tiles here are slices of one whole buffer, with no ``land_lanes``,
    no stripe gather and no collective."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.sharding.flmesh import parse_mesh

    d, m = parse_mesh(MESH_SPEC)
    cfg = paper_cfg(MESH_SPLIT_STRATEGY, MESH_ROUNDS, megastep="stepwise",
                    **cfg_over)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        eng = build_engine(cfg, mesh_model(model), data,
                           list(paper_fleet(cfg.n_clients)), device=dev)
        split_lanes(eng.trainer, d)
        with split_sums(d, m):
            eng.run()
    finally:
        torch.use_deterministic_algorithms(was)
    return {MESH_SPLIT_STRATEGY: {k: v.detach().cpu()
                                  for k, v in eng.params.items()}}


def start_ranks(spec_path: Path, tmp: Path, world: int) -> list:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            MESH_CHILD_ARGV + [str(spec_path), str(r)], env=env, cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs: list, tmp: Path, timeout: float) -> None:
    """Wait for every rank; the first non-zero exit (or the deadline)
    kills the rest and fails the phase with each failed rank's log tail."""
    deadline = time.perf_counter() + timeout
    try:
        while True:
            rcs = [p.poll() for p, _ in procs]
            if any(rc not in (None, 0) for rc in rcs) or \
                    all(rc is not None for rc in rcs):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"mesh ranks still running after "
                                     f"{timeout} s (exit codes {rcs})")
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if any(rcs):
        tails = {r: (tmp / f"rank{r}.log").read_text()[-2000:]
                 for r, rc in enumerate(rcs) if rc}
        raise AssertionError(f"mesh ranks exited {rcs}: {tails}")


def bits(params: dict) -> dict:
    """fp32 params as their int32 bit patterns, for ``same``."""
    return {k: v.contiguous().view(torch.int32) for k, v in params.items()}


def close_params(got: dict, want: dict) -> float:
    """The largest error over its tolerance (PARAM_RTOL / PARAM_ATOL)."""
    worst = 0.0
    for name, leaf in want.items():
        w = leaf.detach().cpu()
        err = (got[name] - w).abs() / (PARAM_ATOL + PARAM_RTOL * w.abs())
        worst = max(worst, float(err.max()))
    return worst


def max_abs_diff(got: dict, want: dict) -> float:
    return max(float((got[k] - v.detach().cpu()).abs().max())
               for k, v in want.items())


def check_mesh_launches(rank: int, run: dict) -> None:
    """``staleness_agg`` once an aggregation, ``fused_adam`` once a local
    step of each cohort's largest budget, the top-k once a round of the
    top-k runs (the megastep config's too)."""
    n = run["launches"]
    topk = "topk" in run["name"] or run["name"].startswith("megastep")
    want = {"staleness_agg": run["aggregations"],
            "fused_adam": sum(run["largest_step_budgets"]),
            "block_topk": run["rounds"] if topk else 0}
    got = {k: n[k] for k in want}
    if got != want:
        raise AssertionError(f"mesh rank {rank} {run['name']}: launches "
                             f"{got}, expected {want}")


def mesh_phase(golden: dict, dev, data_kw: dict, model: str = "MnistCNN",
               cfg_over: Optional[dict] = None,
               mega_over: Optional[dict] = None,
               timeout: float = MESH_TIMEOUT_S) -> dict:
    """The FL mesh plane (``sharding.flmesh``) at ``MESH_SPEC``: four
    ranks, child processes over gloo (``scripts/torch_mesh_child.py``, a
    ``file://`` rendezvous in a temporary folder), all on ``dev`` (one
    card: NCCL refuses two ranks on one device, so this shows the mesh
    over gloo, the card's tensors staged through the host), each running
    ``mesh_runs`` under deterministic algorithms. ``golden`` holds the
    1x1 engines and main-path records of ``MESH_STRATEGIES`` at the same
    config (``{"engines": {...}, "records": {...}}``); the held config's
    1x1 runs are made here first, ``split_golden``'s after the ranks.

    Fails unless every rank exits 0 and, on every rank: every run's host
    trace equals its 1x1 run's; the held runs' params are within
    PARAM_RTOL / PARAM_ATOL of theirs, and ``MESH_SPLIT_STRATEGY``'s wide
    run's of ``split_golden``'s; every run's params equal rank 0's bit
    for bit; the megastep pair is bit-equal with a fused round; the
    launches are as ``check_mesh_launches`` says. The wide run is held to
    ``split_golden`` and not to the plain 1x1 run: on the card a
    64-lane cohort step rounds its near-zero gradients unlike the
    128-lane one, and Adam's normalized step turns each such rounding
    into a step of +lr or -lr (``scripts/mesh_param_drift.py``: one
    cohort split in two at 1x1, 2e-3 after one step), so the wide runs'
    distance from the plain 1x1 runs is reported, not held. Returns the
    phase's record."""
    import tempfile

    from repro_torch.data.synthetic import make_federated_dataset

    cfg_over, mega_over = dict(cfg_over or {}), dict(mega_over or {})
    runs = mesh_runs(data_kw, model, cfg_over, mega_over)
    engines = {**golden["engines"], **held_golden(dev)}
    data = make_federated_dataset(**data_kw)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spec = dict(mesh=MESH_SPEC, world=MESH_WORLD,
                    init=str(tmp / "rendezvous"), out=str(tmp),
                    device=str(dev), runs=runs,
                    durable=dict(strategy=MESH_DUR_STRATEGY,
                                 rounds=DUR_ROUNDS, over=cfg_over,
                                 crash=MESH_DUR_CRASH, data=data_kw,
                                 model=model, root=str(tmp / "durable")))
        (tmp / "spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        wait_ranks(start_ranks(tmp / "spec.json", tmp, MESH_WORLD), tmp,
                   timeout)
        wall = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        params = [{run["name"]: torch.load(
            tmp / f"rank{r}_{run['name']}.pt")["final"] for run in runs}
            for r in range(MESH_WORLD)]
        durable = mesh_durable(ranks, tmp, dev, data, model, cfg_over)
    t0 = time.perf_counter()
    split = split_golden(dev, data, model, cfg_over)
    split_s = time.perf_counter() - t0
    gold = {name: json.loads(json.dumps(host_trace(eng)))
            for name, eng in engines.items()}
    drift, split_drift = {}, {}
    for r, (rec, p) in enumerate(zip(ranks, params)):
        if rec["coords"] != list(divmod(r, 2)):
            raise AssertionError(f"rank {r} sits at {rec['coords']}")
        by = {run["name"]: run for run in rec["runs"]}
        for name, eng in engines.items():
            if by[name]["trace"] != gold[name]:
                raise AssertionError(f"mesh rank {r} {name}: host trace "
                                     "differs from the 1x1 run's")
            err = close_params(p[name], eng.params)
            drift[name] = {"err_over_tol": err,
                           "max_abs": max_abs_diff(p[name], eng.params)}
            if name.startswith("held_") and err > 1.0:
                raise AssertionError(f"mesh rank {r} {name}: params {err} x "
                                     "the tolerance from the 1x1 run's")
        for name, want in split.items():
            err = close_params(p[name], want)
            split_drift[name] = {
                "err_over_tol": err, "max_abs": max_abs_diff(p[name], want),
                "bit_equal": same(bits(p[name]), bits(want))}
            if err > 1.0:
                raise AssertionError(f"mesh rank {r} {name}: params {err} x "
                                     "the tolerance from the split 1x1 "
                                     "run's")
        step, fused = by["megastep_stepwise"], by["megastep_fused"]
        if fused["megastep_rounds"] < 1 or step["megastep_rounds"]:
            raise AssertionError(
                f"mesh rank {r}: {fused['megastep_rounds']} fused rounds "
                f"({fused['megastep_fallback_reason']}), "
                f"{step['megastep_rounds']} stepwise")
        if fused["trace"] != step["trace"] or not same(
                bits(p["megastep_fused"]), bits(p["megastep_stepwise"])):
            raise AssertionError(f"mesh rank {r}: fused differs from "
                                 "stepwise")
        for run in rec["runs"]:
            check_mesh_launches(r, run)
            if not same(bits(p[run["name"]]), bits(params[0][run["name"]])):
                raise AssertionError(f"mesh rank {r} {run['name']}: params "
                                     "differ from rank 0's")
            if run["mesh"] != MESH_SPEC or run["device"] != str(dev):
                raise AssertionError(f"mesh rank {r} ran {run['mesh']} on "
                                     f"{run['device']}")
    per_round = lambda run, key: run[key] / max(run["rounds"], 1)
    first = ranks[0]["runs"][0]
    record = {
        "mesh": MESH_SPEC, "ranks": MESH_WORLD,
        "backend": ranks[0]["backend"], "device": str(dev),
        "staged_through_host": ranks[0]["stages"],
        "note": ("one card: four ranks over gloo on it, the card's tensors "
                 "staged through the host; NCCL across cards not shown"),
        "wall_s": wall,
        "params_vs_1x1": drift,
        "params_vs_split_1x1": split_drift,
        "split_1x1_s": split_s,
        "one_by_one_round_wall_s": {
            name: [x["wall_s"] for x in golden["records"][name]["rounds"]]
            for name in golden["records"]},
        "runs": [{"rank": rec["rank"], "run": run["name"],
                  "round_wall_s": run["round_wall_s"],
                  "wall_s": run["wall_s"], "rounds": run["rounds"],
                  "mesh_host_bytes_per_round": per_round(
                      run, "mesh_host_bytes"),
                  "collective_ms_per_round": 1e3 * per_round(
                      run, "mesh_collective_s"),
                  "collectives_per_round": per_round(run, "mesh_collectives"),
                  "launches": {k: run["launches"][k] for k in (
                      "staleness_agg", "fused_adam", "block_topk")},
                  "megastep_rounds": run["megastep_rounds"]}
                 for rec in ranks for run in rec["runs"]],
        "store_tile": first["store_tile"],
        "store_capacity": first["store_capacity"],
        "row_width": first["row_width"],
        "durable": {k: v for k, v in durable.items() if k != "journal"}}
    apo_run = next(run for run in ranks[0]["runs"]
                   if run["name"] == MESH_DUR_STRATEGY)
    record["durable"]["snapshot_mesh_host_bytes"] = (
        durable["golden"]["mesh_host_bytes"] - apo_run["mesh_host_bytes"])
    emit("mesh", **record)
    record["durable_journal"] = durable["journal"]
    return record


def mesh_durable(ranks: list, tmp: Path, dev, data, model: str,
                 cfg_over: dict) -> dict:
    """The ranks' durable runs (``scripts/torch_mesh_child.py``'s
    ``durable_runs``), checked: on every rank the crash's resume equal to
    its golden run (every ``durable_state`` key and the journal's bytes)
    with the launches its re-executed rounds must make, the golden params
    equal to rank 0's, and the checkpoint's resume at the mesh equal to
    the checkpoint; then that checkpoint resumed here at 1x1 on ``dev``,
    equal to rank 0's checkpoint state, finishing its round with one
    aggregate. Returns the runs' numbers and the golden journal's bytes."""
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.faas.hardware import paper_fleet

    root = tmp / "durable"
    first = None
    for r, rec in enumerate(ranks):
        dur = rec["durable"]
        crash, ckpt = dur["crash"], dur["checkpoint"]
        if crash["differs"]:
            raise AssertionError(f"mesh rank {r}: the resumed durable run "
                                 f"differs in {crash['differs']}")
        if crash["launches"] != crash["launches_wanted"]:
            raise AssertionError(
                f"mesh rank {r}: the resumed durable run launched "
                f"{crash['launches']}, want {crash['launches_wanted']}")
        check_checkpoint(ckpt, f"mesh rank {r}")
        if ckpt["mesh"] != MESH_SPEC:
            raise AssertionError(f"mesh rank {r}: checkpoint resumed under "
                                 f"{ckpt['mesh']}")
        gold = bits(torch.load(tmp / f"rank{r}_durable_golden.pt"))
        first = first or gold
        if not same(gold, first):
            raise AssertionError(f"mesh rank {r}: durable params differ "
                                 "from rank 0's")
    want = torch.load(tmp / "ckpt_want.pt")
    cfg = paper_cfg(MESH_DUR_STRATEGY, 3, engine="scheduler",
                    checkpoint_dir=str(root / "checkpoint"), **cfg_over)
    t0 = time.perf_counter()
    res = Scheduler.resume(cfg, mesh_model(model), data,
                           list(paper_fleet(cfg.n_clients)), device=dev)
    resume_s = time.perf_counter() - t0
    differs = unequal(checkpoint_state(res), want)
    zero_counts()
    m = res.run()
    elastic = {"mesh": m["mesh"], "resume_ms": resume_s * 1e3,
               "differs": differs, "resumed_rounds": m["rounds"],
               "final_round": res.db.round,
               "staleness_agg": read_counts()["staleness_agg"]}
    if differs or m["mesh"] != "1x1" or elastic["final_round"] != 3 or \
            elastic["staleness_agg"] != 1:
        raise AssertionError(f"mesh: the {MESH_SPEC} checkpoint resumed at "
                             f"1x1: {elastic}")
    golden = ranks[0]["durable"]["golden"]
    return {"config": {"strategy": MESH_DUR_STRATEGY, "rounds": DUR_ROUNDS,
                       **cfg_over},
            "golden": golden,
            "snapshot_bytes": snapshot_bytes(str(root / "golden")),
            "per_rank": [{
                "rank": rec["rank"], "wall_s": rec["durable"]["wall_s"],
                "golden_wall_s": rec["durable"]["golden"]["wall_s"],
                "snapshot_ms": rec["durable"]["golden"]["snapshot_ms"],
                "journal_bytes": rec["durable"]["golden"]["journal_bytes"],
                "crash": {k: rec["durable"]["crash"][k] for k in (
                    "point", "crash_after", "snapshot_round",
                    "journal_replayed", "resume_ms", "launches",
                    "live_rows")},
                "checkpoint": {k: rec["durable"]["checkpoint"][k] for k in (
                    "live_rows", "save_ms", "save_mesh_host_bytes",
                    "resume_ms", "staleness_agg")}}
                for rec in ranks],
            "checkpoint_at_1x1": elastic,
            "journal": (root / "golden" / "journal.wal").read_bytes()}


def mesh_kernel_entry(mesh: dict, golden_record: dict, dev) -> dict:
    """``staleness_agg`` at the mesh's tile, ``[C/2, W/2]`` of the
    ``apodotiko`` run's store, the sweep form (a rank's launch) with the
    tile's share of the last aggregate's rows weighted; the launches are
    rank 0's in its ``apodotiko`` run."""
    C, wt = mesh["store_tile"]
    k = -(-golden_record["rounds"][-1]["n_aggregated"] // 2)
    launches = next(r["launches"]["staleness_agg"] for r in mesh["runs"]
                    if r["rank"] == 0 and r["run"] == "apodotiko")
    tile = {"strategy": "apodotiko",
            "rounds": [{"store_capacity": C, "n_aggregated": k}],
            "row_width": wt, "launches": {"staleness_agg": launches}}
    entry = agg_kernel_entry("staleness_agg[mesh]", tile, dev,
                             rows_form=False)
    entry["launches_run"] = (f"mesh phase: rank 0 of {MESH_SPEC}, "
                             f"apodotiko, {MESH_ROUNDS} rounds")
    return entry


# -------------------------------------------------------------------- fleet
FLEET_M, FLEET_CAPACITY, FLEET_K, FLEET_ROUNDS = 1_000_000, 1 << 20, 100, 5
FLEET_BETA, FLUSH_REPS = 1.2, 20


def fleet_store(where):
    """A million clients, each invoked three times with seeded durations
    (so selection scores, not only the uninvoked bootstrap), in a 2^20-slot
    columnar store whose device score state lives on ``where``."""
    from repro_torch.core.database import Database
    from repro_torch.core.fleet_store import FleetStore

    rng = np.random.default_rng(SEED)
    card = rng.integers(50, 500, FLEET_M).astype(np.int64)
    durs = rng.uniform(1.0, 60.0, (FLEET_M, 3))
    db = Database(control_plane="columnar")
    db.fleet = FleetStore(capacity=FLEET_CAPACITY, device=where)
    db.register_clients_bulk(np.arange(FLEET_M), card, 10, 5)
    db.fleet.bulk_history(durs)
    return db


def flush_split(fs, reps: int = FLUSH_REPS) -> dict:
    """The dirty-slot flush that ``select_topk`` runs before its launch,
    on ``fs``'s pending dirty slots (the last round's cohort), repeated
    ``reps`` times on the same slots: whole, and in its three parts, host
    packing (iterating the dirty set, gathering the columns), the
    host-to-device copies and the index writes on the card. Each is the
    median of wall times with the card drained before and after (host
    clock). The writes put back the values already there."""
    dirty = set(fs._dev_dirty)
    dev = fs._device()
    times = {"total": [], "host": [], "h2d": [], "write": []}

    def timed(part, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[part].append((time.perf_counter() - t) * 1e3)
        return out

    for _ in range(reps):
        fs._dev_dirty.update(dirty)
        timed("total", fs._flush_device)
        fs._dev_dirty.update(dirty)
        cols = timed("host", fs._dirty_columns)
        tensors = timed("h2d", lambda: dev.upload(*cols))
        timed("write", lambda: dev.write(*tensors))
    return {"slots": len(dirty), "reps": reps,
            "first_total_ms": times["total"][0],
            **{f"{part}_ms": statistics.median(t)
               for part, t in times.items()}}


def fleet_phase(dev) -> tuple[dict, object]:
    """Five rounds of ``select_topk`` at M = 1e6 on the card and on a CPU
    copy of the same state: each round selects, marks the cohort running,
    then completes it with seeded durations. Selections and the device
    booster must be identical, and each call on the card one launch.
    Returns the phase record and the card store's device score state."""
    from repro_torch.kernels.topk import block_topk

    t0 = time.perf_counter()
    card_db, cpu_db = fleet_store(dev), fleet_store("cpu")
    setup_s = time.perf_counter() - t0
    if card_db.fleet.capacity != FLEET_CAPACITY:
        raise AssertionError(f"capacity {card_db.fleet.capacity}")
    ms, launches = [], []
    for t in range(FLEET_ROUNDS):
        before = block_topk.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sel = card_db.fleet.select_topk(FLEET_K, FLEET_BETA)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        launches.append(block_topk.launches - before)
        before = block_topk.launches
        sel_cpu = cpu_db.fleet.select_topk(FLEET_K, FLEET_BETA)
        if block_topk.launches != before:
            raise AssertionError("the CPU store launched the kernel")
        if sel != sel_cpu or len(sel) != FLEET_K:
            raise AssertionError(f"round {t}: card and CPU selections differ")
        a = card_db.fleet._dev.booster.cpu().view(torch.int32)
        b = cpu_db.fleet._dev.booster.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"round {t}: device booster differs")
        for db in (card_db, cpu_db):
            for j, cid in enumerate(sel):
                db.mark_running(cid, t)
                db.mark_complete(cid, 1.0 + ((cid * 7 + j + t) % 50))
    record = {"M": FLEET_M, "capacity": FLEET_CAPACITY, "k": FLEET_K,
              "rounds": FLEET_ROUNDS, "setup_s": setup_s,
              "select_topk_ms": ms,
              "select_topk_median_ms": statistics.median(ms),
              "launches_per_call": launches,
              "flush": flush_split(card_db.fleet)}
    emit("fleet", **record)
    if launches != [1] * FLEET_ROUNDS:
        raise AssertionError(f"select_topk on the card launched {launches} "
                             "kernels per call, not one")
    return record, card_db.fleet._dev


SORT_K_MASKED, SORT_K_SCORED = 4096, 1025   # past the kernel's k <= 1024


def topk_sort_route_phase(state, dev) -> dict:
    """The top-k past the kernel's k (k > 1024: the sort route, the
    counterpart of the reference's ``lax.top_k`` route) at fleet scale on
    the card: ``ops.masked_topk`` at k = 4096 on the seeded 2^20
    fleet-shaped scores and ``ops.scored_topk`` at k = 1025 on the fleet
    phase's device state, each held to its plain version on the card and
    on CPU copies to the bit (vals and idx; idx, valid and the new
    booster). The sort route must run once a call (``masked_topk.sorts``)
    and the kernel never (``block_topk.launches``). Median ms a call, each
    beside its byte bound and ``torch.topk``'s time at the same k on the
    same scores."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.topk import block_topk, masked_topk

    s = topk_scores(FLEET_CAPACITY, dev)
    args = (state.num, state.den, state.booster, state.eligible, state.ever,
            FLEET_BETA, SORT_K_SCORED)
    sorts, launches = masked_topk.sorts, block_topk.launches
    vals, idx = ops.masked_topk(s, SORT_K_MASKED)
    got = ops.scored_topk(*args)
    torch.cuda.synchronize()
    counts = {"sorts": masked_topk.sorts - sorts,
              "kernel_launches": block_topk.launches - launches}
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    wants = {"masked_topk": (ref.masked_topk(s, SORT_K_MASKED),
                             ref.masked_topk(s.cpu(), SORT_K_MASKED)),
             "scored_topk": (ref.scored_topk(*args),
                             ref.scored_topk(*cpu_args))}
    for name, result in (("masked_topk", (vals, idx)),
                         ("scored_topk", got)):
        for where, want in zip(("card", "CPU"), wants[name]):
            for a, b in zip(result, want):
                a, b = a.cpu(), b.cpu()
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} past k = 1024 differs "
                                         f"from the plain version on the "
                                         f"{where}")
    m = FLEET_CAPACITY
    # bytes as the kernel entries count them: the scores read and the k
    # values and int64 indices written; the step's 18 B a slot (num, den,
    # booster, eligible, ever read, the booster written) and 9 B a pick
    masked_bytes = 4 * m + 12 * SORT_K_MASKED
    scored_bytes = 18 * m + 9 * SORT_K_SCORED
    record = {"M": m, "masked_k": SORT_K_MASKED,
              "scored_k": SORT_K_SCORED, **counts, "exact": True,
              "scored_valid": int(got[1].sum()),
              "masked_ms": time_ms(lambda: ops.masked_topk(s, SORT_K_MASKED)),
              "scored_ms": time_ms(lambda: ops.scored_topk(*args)),
              "masked_bytes": masked_bytes,
              "masked_bound_ms": bound(masked_bytes, m)[0],
              "scored_bytes": scored_bytes,
              "scored_bound_ms": bound(scored_bytes, m)[0],
              # torch.topk on the same scores at each k (no ordering of
              # ties promised; a yardstick of time only)
              "masked_library_ms": time_ms(
                  lambda: torch.topk(s, SORT_K_MASKED)),
              "scored_library_ms": time_ms(
                  lambda: torch.topk(s, SORT_K_SCORED))}
    emit("topk_sort_route", **record)
    if counts != {"sorts": 2, "kernel_launches": 0}:
        raise AssertionError(f"past k = 1024: {counts}, want one sort a "
                             "call and no kernel launch")
    return record


def reference_phase(dev) -> None:
    """Small ProxyCNN runs on the card vs the same runs on the CPU (among
    them ``scaffold``, its ``c_global`` too, and a fused-megastep run on
    zero-variability hardware, its megastep counters equal), a ProxyLSTM
    run on the shakespeare proxy (SGD: no ``fused_adam``), and the
    Controller poll loop vs the Scheduler on the card."""
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import Scheduler, build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.proxy_models import ProxyCNN, ProxyLSTM

    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    init = params_to_numpy(ProxyCNN(10).init(torch.Generator().manual_seed(1)))
    # the sweep's shakespeare cell: ProxyLSTM on 20-character sequences,
    # SGD 0.5, batch 8 (sweep/runner.py)
    lstm = ProxyLSTM(vocab=82, seq_len=20)
    lstm_data = make_federated_dataset("shakespeare", n_clients=10,
                                       scale=0.05, seed=0)
    lstm_init = params_to_numpy(lstm.init(torch.Generator().manual_seed(1)))
    lstm_case = dict(optimizer="sgd", lr=0.5, batch_size=8)
    base = dict(n_clients=10, clients_per_round=4, rounds=3, local_epochs=1,
                batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0)
    # the reference's smoke_hedge setting, on its straggler hardware mix
    hedge = dict(rounds=4, cold_start_s=120.0, keep_warm=30.0,
                 hedge_fraction=1.0, concurrency_ratio=0.5)
    # tests/trace_harness.py's megastep_cfg: 3 bootstrap rounds, 5 fused
    fused = dict(rounds=8, strategy="apodotiko-topk", concurrency_ratio=1.0,
                 eval_every=0, keep_warm=1e9, megastep="fused")
    cases = {"fedavg": {}, "apodotiko": {}, "apodotiko-topk": {},
             "apodotiko-hedge": hedge, "scaffold": {},
             "apodotiko-topk[fused]": fused,
             "apodotiko[shakespeare]": lstm_case}
    out = {}
    for name, over in cases.items():
        strategy = name.split("[")[0]
        kw = {**base, "strategy": strategy, **over}
        model, case_data, case_init = ((lstm, lstm_data, lstm_init)
                                       if over is lstm_case
                                       else (ProxyCNN(10), data, init))
        kernels = path_kernels(strategy, kw.get("optimizer", "adam"))
        runs = {}
        for where in (dev, "cpu"):
            fleet = (straggler_fleet(10) if strategy == "apodotiko-hedge"
                     else det_fleet(10) if over is fused
                     else list(paper_fleet(10)))
            eng = build_engine(FLConfig(**kw), model, case_data, fleet,
                               device=where,
                               init_params=params_from_numpy(case_init,
                                                             where))
            eng.trainer.batch_indices = NumpyBatchIndices(7, kw["batch_size"])
            before = read_counts()
            m = eng.run()
            after = read_counts()
            runs[str(where)] = (eng, m, tuple(after[k] - before[k]
                                              for k in kernels))
        (card, m_card, card_launches) = runs[str(dev)]
        (cpu, m_cpu, cpu_launches) = runs["cpu"]
        if host_trace(card) != host_trace(cpu):
            raise AssertionError(f"{name}: host trace differs card vs cpu")
        extra = {}
        mega = {k: m_card[k] for k in ("megastep_rounds", "megastep_scans",
                                       "megastep_fallback_reason")}
        if mega != {k: m_cpu[k] for k in mega}:
            raise AssertionError(f"{name}: megastep counters differ card "
                                 "vs cpu")
        if (mega["megastep_rounds"] > 0) != (over is fused):
            raise AssertionError(f"{name}: {mega}")
        if min(card_launches) <= 0 or max(cpu_launches) != 0:
            raise AssertionError(f"{name}: launches card {card_launches} "
                                 f"cpu {cpu_launches}")
        if m_card["n_hedges"] != m_cpu["n_hedges"]:
            raise AssertionError(f"{name}: hedges differ")
        if strategy == "apodotiko-hedge" and m_card["n_hedges"] <= 0:
            raise AssertionError("apodotiko-hedge fired no hedge")
        err = 0.0
        for leaf_name, leaf in card.params.items():
            a, b = leaf.cpu().numpy(), cpu.params[leaf_name].numpy()
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{name}: {leaf_name}")
            err = max(err, float(np.max(np.abs(a - b))))
        if strategy == "scaffold":
            # a variate divides a params difference by steps * lr, so its
            # absolute tolerance is the params' over lr
            a, b = card.c_global.cpu().numpy(), cpu.c_global.numpy()
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL / card.cfg.lr,
                                       err_msg=f"{name}: c_global")
            extra["c_global_max_abs_err"] = float(np.max(np.abs(a - b)))
            extra["c_global_atol"] = PARAM_ATOL / card.cfg.lr
        acc_card = [l.accuracy for l in card.history]
        acc_cpu = [l.accuracy for l in cpu.history]
        out[name] = {**extra, "params_max_abs_err": err, "acc_card": acc_card,
                     "acc_cpu": acc_cpu, "rounds": len(card.history),
                     "engine": m_card["engine"],
                     "n_hedges": m_card["n_hedges"], **mega,
                     "card_launches": dict(zip(kernels, card_launches))}

    # the poll loop against the Scheduler, both on the card
    cfg = FLConfig(**base, strategy="apodotiko")
    engines = []
    for cls in (Controller, Scheduler):
        eng = cls(cfg, ProxyCNN(10), data, list(paper_fleet(10)), device=dev,
                  init_params=params_from_numpy(init, dev))
        eng.trainer.batch_indices = NumpyBatchIndices(7, 5)
        eng.run()
        engines.append(eng)
    if host_trace(engines[0]) != host_trace(engines[1]):
        raise AssertionError("Controller and Scheduler traces differ")
    out["controller_vs_scheduler"] = {
        "identical_host_trace": True,
        "params_max_abs_diff": max(
            float((a - engines[1].params[n]).abs().max())
            for n, a in engines[0].params.items())}
    emit("reference", rtol=PARAM_RTOL, atol=PARAM_ATOL, **out)


PROFILE_EPOCHS = 1     # the profiled round's E: 30 local steps, not 150


def profile_round(data, dev, unprofiled_wall_s: float,
                  unprofiled_steps: int) -> None:
    """One more fedavg round of the main-path setup at ``PROFILE_EPOCHS``
    local epochs (a fifth of the main path's 150 local steps: the profiler's
    host-side parsing grows with the device events) under torch.profiler
    (device activity only, to keep the host-side overhead small): device
    busy time as the union of kernel intervals, the idle share, and kernel
    time by name. Per local step (of the cohort's largest budget), the
    profiled wall, the busy time and the events, beside the unprofiled
    wall of a local step of the main path's fedavg round
    (``unprofiled_wall_s`` over its ``unprofiled_steps``; that round's
    fixed costs, the evaluation among them, spread over five times the
    steps, so no idle share is taken against it)."""
    from torch.profiler import ProfilerActivity, profile

    ctl = paper_engine("fedavg", 1, data, dev, local_epochs=PROFILE_EPOCHS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:                       # union of kernel intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy = busy_us / 1e6
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            entry = by_name[e.name[:90]]
            entry[0] += 1
            entry[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    steps = max(step_budget(data, r.client_id, ctl.cfg.batch_size,
                            PROFILE_EPOCHS) for r in ctl.platform.invocations)
    emit("profile", strategy="fedavg", rounds=1,
         local_epochs=PROFILE_EPOCHS, local_steps=steps,
         profiled_wall_s=wall, device_busy_s=busy,
         n_device_events=len(spans),
         idle_share=(1 - busy / wall) if busy else None,
         wall_ms_per_local_step=wall / steps * 1e3,
         busy_ms_per_local_step=busy / steps * 1e3,
         events_per_local_step=len(spans) / steps,
         unprofiled_wall_ms_per_local_step=(unprofiled_wall_s
                                            / unprofiled_steps * 1e3),
         top=[{"name": n, "calls": c, "ms": ms} for n, (c, ms) in top])


# ------------------------------------------------------------- paper models
# The paper's IV-A settings of the other three models
# (src/repro/configs/paper_{femnist,speech,shakespeare}.py: E, B, optimizer,
# learning rate), each on the MNIST run's fleet: 200 clients on the 65/25/10
# mix, 100 a round, apodotiko, CR 0.3. Only the rounds are cut.
PAPER_RUNS = {
    "femnist": dict(rounds=1, local_epochs=5, batch_size=10,
                    optimizer="adam", lr=1e-3, n_params=6_603_710),
    "speech": dict(rounds=1, local_epochs=5, batch_size=5,
                   optimizer="adam", lr=1e-3, n_params=67_267),
    # 1 round: 2 until the mesh phase, cut to keep the script under 1,000 s
    "shakespeare": dict(rounds=1, local_epochs=1, batch_size=32,
                        optimizer="sgd", lr=0.8, n_params=818_402),
}
PAPER_DATA_SCALE = 1.0   # the datasets' own scale (no cut)


def paper_model_run(name: str, dev, n_clients: int = 200,
                    clients_per_round: int = 100,
                    data_scale: float = PAPER_DATA_SCALE) -> dict:
    """One paper-width ``build_engine`` run of ``paper-<name>`` on the
    paper's data shapes, every kernel count zeroed just before and read just
    after. Fails unless the params are finite and of the model's shapes, the
    count is the paper's, every round ran, and the launches are the path's:
    ``staleness_agg`` once a round, ``fused_adam`` once a local step of each
    cohort's largest budget (Adam) or never (SGD). Returns the record the
    kernel entries read."""
    from repro_torch.core import aggregation
    from repro_torch.core.scheduler import build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import build_paper_model

    run = dict(PAPER_RUNS[name])
    n_params = run.pop("n_params")
    t0 = time.perf_counter()
    data = make_federated_dataset(name, n_clients=n_clients,
                                  scale=data_scale, seed=SEED,
                                  fidelity="paper")
    data_s = time.perf_counter() - t0
    model = build_paper_model(f"paper-{name}")
    cfg = FLConfig(n_clients=n_clients, clients_per_round=clients_per_round,
                   strategy="apodotiko", concurrency_ratio=0.3, seed=SEED,
                   **run)
    eng = build_engine(cfg, model, data, list(paper_fleet(n_clients)),
                       device=dev)
    rounds_log, clock = [], [0.0]

    def progress(log):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rounds_log.append({
            "round": log.round, "wall_s": now - clock[0],
            "accuracy": log.accuracy, "n_aggregated": log.n_aggregated,
            "n_stale": log.n_stale, "store_capacity": eng.store.capacity,
            "agg_route": aggregation.last_path()})
        clock[0] = now

    zero_counts()
    torch.cuda.synchronize()
    clock[0] = time.perf_counter()
    metrics = eng.run(progress=progress)
    torch.cuda.synchronize()
    launches = read_counts()

    # one trainer call a cohort: the invocations of one (round, instant)
    cohorts = collections.defaultdict(list)
    for r in eng.platform.invocations:
        cohorts[(r.round, r.t_invoked)].append(step_budget(
            data, r.client_id, cfg.batch_size, cfg.local_epochs))
    budgets = [max(v) for _, v in sorted(cohorts.items())]
    want = {"staleness_agg": cfg.rounds,
            "fused_adam": sum(budgets) if cfg.optimizer == "adam" else 0}
    finite = all(bool(torch.isfinite(p).all()) for p in eng.params.values())
    per_round = collections.Counter(r.round for r in eng.platform.invocations)
    record = {"model": f"paper-{name}", "strategy": cfg.strategy,
              "optimizer": cfg.optimizer, "data_scale": data_scale,
              "data_s": data_s, "X": list(data.X.shape),
              "X_dtype": str(data.X.dtype), "n_params": eng.spec.n_params,
              "row_width": eng.store.row_width, "rounds": rounds_log,
              "cohort_sizes": [per_round[r] for r in sorted(per_round)],
              "cohort_step_budgets": budgets,
              "largest_step_budget": max(budgets),
              "launches": launches, "launches_wanted": want,
              "final_accuracy": metrics["final_accuracy"],
              "total_sim_time_s": metrics["total_time"],
              "megastep_fallback_reason": metrics["megastep_fallback_reason"],
              "params_finite": finite}
    emit("paper_model", **record)

    if metrics["engine"] != "scheduler":
        raise AssertionError(f"build_engine ran {metrics['engine']}")
    if eng.spec.n_params != n_params:
        raise AssertionError(f"paper-{name} has {eng.spec.n_params} params, "
                             f"want {n_params}")
    if len(eng.history) != cfg.rounds:
        raise AssertionError(f"paper-{name}: {len(eng.history)} of "
                             f"{cfg.rounds} rounds ran")
    template = model.init(torch.Generator().manual_seed(0))
    for leaf_name, leaf in eng.params.items():
        if tuple(leaf.shape) != tuple(template[leaf_name].shape):
            raise AssertionError(f"paper-{name} {leaf_name}: shape "
                                 f"{tuple(leaf.shape)}")
    if not finite or any(p.device.type != dev.type
                         for p in eng.params.values()):
        raise AssertionError(f"paper-{name}: params not finite on {dev}")
    if not all(0.0 <= r["accuracy"] <= 1.0 for r in rounds_log):
        raise AssertionError(f"paper-{name}: accuracy out of [0, 1]")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"paper-{name}: {k} launched {launches[k]} "
                                 f"times, want {n}")
    return record


def paper_models_phase(dev, **size) -> dict:
    """The paper's other three models at published width, one run each
    (``paper_model_run``; ``size`` cuts clients or data for a rehearsal);
    the engine and its data are let go after each."""
    records = {}
    for name in PAPER_RUNS:
        records[name] = paper_model_run(name, dev, **size)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------------------- lm
LM_ARCH = "qwen3-1.7b"
# serve: 4 prompts of 512 tokens into a cache of 576, greedy decode of 64
# tokens (the prefill's pick, then 63 decode steps) to fill it, in the
# published bf16 and again in fp32
LM_SERVE = dict(batch=4, prompt=512, cache=576)
LM_SERVE_DTYPES = ("bfloat16", "float32")
LM_TRAIN = dict(steps=3, batch=4, seq=1024)
# the federated run: the example's --full model (12 L, d 768, vocab
# 32,000: 100,094,208 params) over 12 clients for 3 rounds, its setup
# (``fl_config``), on the example's Markov token streams over a 2,048-token
# vocabulary: at the model's 32,000 the streams' transition matrices take
# 9 x 32,000^2 Dirichlet draws, ~8.5 minutes and ~72 GB of host memory on
# the chip machine (PR 23 probe), a cost of the data, not of the model.
# Its host trace is held card against CPU through the example's ``main``
# at its container size
LM_FL = dict(clients=12, rounds=3, data_vocab=2048, full=True)
LM_TRACE_ARGS = ("--clients", "12", "--rounds", "3")
LM_FL_EXAMPLE = ROOT / "examples" / "torch_train_fl_lm.py"
# each decoded position's logits against the full forward's at that
# position, as the relative L2 error over the vocabulary. Both paths run
# the same weights at other shapes (one query row against the cache, 576
# rows at once), so they round apart. bf16: 2^-8 a rounding in each of the
# 28 layers (at 8 layers on the CPU the largest was 1.7 %, the median 0.5
# %; a random walk over 28 layers gives ~3 %). fp32 (TF32 off, torch's
# default for matmuls): only the reductions' order differs, ~1e-6 a layer
LM_DECODE_RTOL = {"bfloat16": 5e-2, "float32": 1e-3}
LM_CHECK_CHUNK = 1 << 27      # columns a plain-version check takes at once
# columns the plain Adam is timed over at once: at 2.1 B columns its ~24 B
# a column of temporaries would not fit beside its 16 B a column of inputs
ADAM_PLAIN_PIECE = 1 << 29


def load_example(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reset_peak(dev) -> None:
    """Free what earlier runs left (their engines hold reference cycles)
    and start the peak-memory count."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)     # the allocator exists from here
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None)


def greedy_serve(lm, params, prompts, cache: int, prefills: int = 2,
                 memory=None) -> tuple:
    """Prefill ``prompts`` (with the ``memory`` inputs, patches or frames)
    into a cache of ``cache`` slots ``prefills`` times (the first warms
    cuBLAS and the allocator), then decode greedily to fill the cache.
    Returns (each prefill's ms, the decode's seconds, the logits of every
    picked position [B, n, V], the picks [B, n])."""
    prompt = prompts.shape[1]
    prefill_ms = []
    for _ in range(prefills):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, _ = lm.apply(params, {"tokens": prompts,
                                              **(memory or {})},
                                     make_cache=True, cache_len=cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    rows = [logits[:, -1]]
    tok = torch.argmax(rows[-1], dim=-1)[:, None]
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(cache - prompt - 1):
        logits, caches = lm.decode_step(params, caches, tok, prompt + i)
        rows.append(logits[:, -1])
        tok = torch.argmax(rows[-1], dim=-1)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return (prefill_ms, decode_s, torch.stack(rows, dim=1).float(),
            torch.cat(toks, dim=1))


def serve_capacities(cfg, batch: int, prompt: int, cache: int) -> dict:
    """The MoE capacity of each call a serve check makes (prefill, one
    decode step, the full forward over the decoded sequence) against its
    token count."""
    from repro_torch.models.moe import capacity

    calls = {"prefill": batch * prompt, "decode": batch,
             "full": batch * (cache - 1)}
    return {k: {"tokens": t, "capacity": capacity(t, cfg)}
            for k, t in calls.items()}


def serve_config(arch: str, layers, smoke: bool = False, dtype=None):
    """``arch``'s config (its smoke config with ``smoke``) cut to
    ``layers`` as ``launch.train --layers`` cuts it, in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth

    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = cut_depth(cfg, layers)
    if dtype:
        cfg = cfg.with_(param_dtype=dtype, compute_dtype=dtype)
    return cfg


def lm_serve(dev, cfg, batch: int, prompt: int, cache: int,
             check_cfg=None, decode_rtol=LM_DECODE_RTOL) -> dict:
    """``build_model(cfg)`` at ``cfg``'s width and dtype, initialized on
    ``dev``: prefill (twice), greedy decode to fill the cache, then the
    full forward over the decoded sequence; each decoded position's logits
    within ``decode_rtol[dtype]`` of the full forward's. A VLM's gates are
    set to ``VLM_GATE`` after init and it sees random patches, an enc-dec
    random frames (``launch.train.memory_inputs``, drawn after the
    prompts), so cross attention moves the logits. With ``check_cfg`` (an
    MoE config at a capacity that drops no token) the timed run is
    ``cfg``'s and the decode and the full forward of the check are
    ``check_cfg``'s, on the same params; every call's capacity must hold
    all its tokens."""
    from repro_torch.launch.train import memory_inputs
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    reset_peak(dev)
    lm = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = peak_gb(dev)
    if cfg.family == "vlm":
        params["layers"]["cross"]["xattn"]["gate"].fill_(VLM_GATE)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                            device=dev)
    memory = memory_inputs(cfg, batch, prompt, gen, dev)
    caps = None
    with torch.no_grad():
        prefill_ms, decode_s, dec, seqs = greedy_serve(lm, params, prompts,
                                                       cache, memory=memory)
        if check_cfg is not None:
            caps = serve_capacities(check_cfg, batch, prompt, cache)
            if any(c["capacity"] < c["tokens"] for c in caps.values()):
                raise AssertionError(f"lm serve: a check call can drop "
                                     f"tokens: {caps}")
            lm = build_model(check_cfg)
            _, _, dec, seqs = greedy_serve(lm, params, prompts, cache, 1)
        full, _, _ = lm.apply(params, {"tokens": torch.cat(
            [prompts, seqs[:, :-1]], dim=1), **memory})
        full = full[:, prompt - 1:].float()
        rel = (dec - full).norm(dim=-1) / full.norm(dim=-1)
        agree = (dec.argmax(-1) == full.argmax(-1)).float().mean()
    steps = cache - prompt - 1
    rtol = decode_rtol[cfg.param_dtype]
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": count_params(params),
           "dtype": cfg.param_dtype, "batch": batch, "prompt": prompt,
           "cache": cache, "decoded_tokens": seqs.shape[1],
           "decode_steps": steps, "init_s": init_s,
           "prefill_ms_first": prefill_ms[0], "prefill_ms": prefill_ms[1],
           "decode_s": decode_s,
           "decode_tokens_per_s": steps * batch / decode_s,
           "decode_ms_per_step": decode_s / steps * 1e3,
           "decode_rel_l2_max": float(rel.max()),
           "decode_rel_l2_median": float(rel.median()),
           "decode_rtol": rtol,
           "argmax_agreement": float(agree),
           "logits_finite": bool(torch.isfinite(dec).all()),
           "init_peak_gb": init_peak, "peak_gb": peak_gb(dev)}
    if memory:
        rec["memory"] = {k: list(v.shape) for k, v in memory.items()}
    if cfg.family == "vlm":
        rec["gate"] = VLM_GATE
    if check_cfg is not None:
        rec["capacity_factor"] = cfg.capacity_factor
        rec["check_capacity_factor"] = check_cfg.capacity_factor
        rec["check_capacities"] = caps
    del params, full, dec, memory
    if not rec["logits_finite"]:
        raise AssertionError(f"lm serve: {cfg.name} decoded non-finite logits")
    if rec["decode_rel_l2_max"] > rtol:
        raise AssertionError(
            f"lm serve ({cfg.name}, {cfg.param_dtype}): decode vs full "
            f"forward relative L2 {rec['decode_rel_l2_max']} > {rtol}")
    return rec


def lm_train(dev, arch: str, smoke: bool, steps: int, batch: int,
             seq: int, layers=None) -> dict:
    """``repro_torch.launch.train.main`` for ``arch`` (its depth cut to
    ``layers`` when given), every kernel count zeroed just before and read
    just after: a finite loss at every step, one ``fused_adam`` launch a
    step, and the step-0 batch's loss lower after the steps than it was at
    step 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--device", str(dev)] + (
                ["--smoke"] if smoke else []) + (
                ["--layers", str(layers)] if layers else [])
    reset_peak(dev)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = train.cut_depth(cfg, layers)
    first = train.step_batch(np.random.default_rng(0), cfg, batch, seq, dev)
    with torch.no_grad():
        again = float(build_model(cfg).loss(out["params"], first)[0])
    rec = {"arch": arch, "smoke": smoke, "n_layers": cfg.n_layers,
           "n_params": out["n_params"],
           "dtype": cfg.param_dtype, "optimizer": cfg.optimizer,
           "remat": cfg.remat, "steps": steps, "batch": batch,
           "tokens_per_step": batch * (seq - 1), "losses": out["losses"],
           "step_s": out["step_s"],
           "step_ms": statistics.median(out["step_s"][1:] or out["step_s"])
           * 1e3,
           "step0_batch_loss_after": again, "wall_s": wall_s,
           "launches": launches, "launches_wanted": {"fused_adam": steps},
           "peak_gb": peak_gb(dev)}
    del out
    if not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"lm train: non-finite loss {rec['losses']}")
    if not again < rec["losses"][0]:
        raise AssertionError(f"lm train: the step-0 batch's loss went from "
                             f"{rec['losses'][0]} to {again}")
    if launches["fused_adam"] != steps:
        raise AssertionError(f"lm train: fused_adam launched "
                             f"{launches['fused_adam']} times in {steps} "
                             "steps")
    return rec


def lm_fl_run(dev, argv) -> tuple:
    """The federated LM example's ``main`` on ``dev`` (its prints to
    stderr). Returns (controller, metrics)."""
    ex = load_example(LM_FL_EXAMPLE)
    with contextlib.redirect_stdout(sys.stderr):
        return ex.main([*argv, "--device", str(dev)])


def lm_fl(dev, clients: int, rounds: int, data_vocab: int, full: bool,
          trace_argv=LM_TRACE_ARGS, arch: str = LM_ARCH,
          phase: str = "lm") -> dict:
    """The federated LM example's setup (its ``lm_config``, ``fl_config``
    and ``make_lm_federated_data`` over ``data_vocab`` tokens) through the
    ``Controller`` on ``dev``, every kernel count zeroed just before the
    run and read just after: ``staleness_agg`` once an aggregation and
    ``fused_adam`` once a local step of each cohort's largest budget,
    finite params (the record the kernel entries read); then the example's
    ``main`` at ``trace_argv`` on the card and on the CPU: host traces and
    the host's metrics equal."""
    from repro_torch.core import aggregation
    from repro_torch.core.controller import Controller
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.models.api import LMClientAdapter

    ex = load_example(LM_FL_EXAMPLE)
    cfg = ex.lm_config(arch, full)
    t0 = time.perf_counter()
    data = ex.make_lm_federated_data(clients, data_vocab, seq_len=32,
                                     samples_per_client=24)
    data_s = time.perf_counter() - t0
    reset_peak(dev)
    ctl = Controller(ex.fl_config(clients, rounds), LMClientAdapter(cfg),
                     data, list(paper_fleet(clients)), device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = ctl.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    cohorts = collections.defaultdict(list)
    for r in ctl.platform.invocations:
        cohorts[(r.round, r.t_invoked)].append(step_budget(
            data, r.client_id, ctl.cfg.batch_size, ctl.cfg.local_epochs))
    budgets = [max(v) for _, v in sorted(cohorts.items())]
    per_round = collections.Counter(r.round for r in ctl.platform.invocations)
    want = {"staleness_agg": sum(1 for l in ctl.history
                                 if l.n_aggregated > 0),
            "fused_adam": sum(budgets)}
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(ctl.params))
    rec = {"model": (f"{cfg.name}, {cfg.n_layers} L, d {cfg.d_model}, "
                     f"vocab {cfg.vocab_size}"), "phase": phase,
           "strategy": ctl.cfg.strategy, "n_params": ctl.spec.n_params,
           "row_width": ctl.store.row_width, "data_vocab": data_vocab,
           "data_s": data_s,
           "rounds": [{"round": l.round, "n_aggregated": l.n_aggregated,
                       "accuracy": l.accuracy,
                       "store_capacity": ctl.store.capacity}
                      for l in ctl.history],
           "cohort_sizes": [per_round[r] for r in sorted(per_round)],
           "cohort_step_budgets": budgets, "agg_route": aggregation.last_path(),
           "wall_s": wall_s, "wall_s_per_round": wall_s / rounds,
           "total_sim_time_s": m["total_time"],
           "final_accuracy": m["final_accuracy"], "launches": launches,
           "launches_wanted": want, "params_finite": finite,
           "peak_gb": peak_gb(dev)}
    del ctl
    if not finite:
        raise AssertionError(f"{phase} fl: params not finite")
    if want["staleness_agg"] < 1 or any(launches[k] != n
                                        for k, n in want.items()):
        raise AssertionError(f"{phase} fl: launches {launches}, want {want}")
    card, m_card = lm_fl_run(dev, trace_argv)
    cpu, m_cpu = lm_fl_run(torch.device("cpu"), trace_argv)
    keys = ("total_time", "total_cost_usd", "cold_start_ratio",
            "n_invocations", "invocation_counts")
    rec["trace_run"] = " ".join(trace_argv)
    rec["trace_equal"] = host_trace(card) == host_trace(cpu)
    rec["trace_metrics_equal"] = all(m_card[k] == m_cpu[k] for k in keys)
    rec["trace_accuracy_card_cpu"] = [m_card["final_accuracy"],
                                      m_cpu["final_accuracy"]]
    if not (rec["trace_equal"] and rec["trace_metrics_equal"]):
        raise AssertionError(f"{phase} fl: host trace card vs CPU differs")
    return rec


def lm_phase(dev, arch: str = LM_ARCH, smoke: bool = False, serve=None,
             train=None, fl=None, trace_argv=LM_TRACE_ARGS) -> dict:
    """The dense LM family on the card: serving (bf16 and fp32) and
    training Qwen3-1.7B at its published width, and the federated LM
    example's setup (``lm_serve``, ``lm_train``, ``lm_fl``); ``smoke`` and
    the sizes cut it for a rehearsal. One JSON line."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch, smoke=smoke)
    serve_rec = {dt: lm_serve(dev, cfg.with_(param_dtype=dt, compute_dtype=dt),
                              **(serve or LM_SERVE))
                 for dt in LM_SERVE_DTYPES}
    train_rec = lm_train(dev, arch, smoke, **(train or LM_TRAIN))
    fl_rec = lm_fl(dev, **(fl or LM_FL), trace_argv=trace_argv)
    rec = {"serve": serve_rec, "train": train_rec, "fl": fl_rec,
           "wall_s": time.perf_counter() - t0}
    emit("lm", **rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------- moe
# DeepSeek-V2-Lite served uncut (27 L, 15,706,484,224 params, bf16: 31.4 GB)
# and Arctic's published width cut to 1 layer (14,069,945,344 params, 28.1
# GB; two layers would be 55.4 GB before any activation). Each serve run is
# timed at the published capacity factor; its decode check runs on the
# same params at ceil(n_experts / top_k), where no call can drop a token
# (at 1.25 the full forward over 4 x 575 tokens drops tokens that decode
# does not), and again in fp32 at DeepSeek's 3-layer cut
MOE_SERVE = {"deepseek-v2-lite-16b": dict(layers=None, batch=4, prompt=512,
                                          cache=576),
             "arctic-480b": dict(layers=1, batch=4, prompt=128, cache=160)}
MOE_FP32 = dict(arch="deepseek-v2-lite-16b", layers=3, batch=4, prompt=512,
                cache=576)
# training at DeepSeek's 3-layer cut (1 MLA-dense, 2 MLA-MoE layers:
# 1,670,135,296 params): its fused Adam's fp32 rows at all 27 layers would
# be ~375 GB. Adafactor at the same cut and width; Arctic's own (smoke)
# launch.train run, Adafactor, card against CPU
MOE_TRAIN = dict(arch="deepseek-v2-lite-16b", smoke=False, layers=3, steps=3,
                 batch=4, seq=1024)
# Adafactor's lr at width: the reference's formula has no relative step
# size, so each step moves every weight by about lr (its RMS clip), and at
# d 2,048 (weights of RMS 0.022) lr 1e-2, Arctic's config value, sends the
# first batch's loss from 9.4 to 45 in 3 steps, the reference's own
# Adafactor as much (CPU probes at DeepSeek's width over 8,192 tokens);
# at 1e-3 it falls to 6.7
MOE_ADAFACTOR_LR = 1e-3
MOE_SMOKE_TRAIN = ("--arch", "arctic-480b", "--smoke", "--steps", "4",
                   "--batch", "4", "--seq", "64")
SMOKE_TRAIN_RTOL = 1e-4       # a smoke run's losses, card against CPU
# the federated MoE: the example at its container size (DeepSeek's smoke
# config, vocabulary 256), as the example runs it by default
MOE_FL = dict(arch="deepseek-v2-lite-16b", clients=12, rounds=3,
              data_vocab=256, full=False)
MOE_TRACE_ARGS = ("--arch", "deepseek-v2-lite-16b", "--clients", "12",
                  "--rounds", "3")


def no_drop_cf(cfg) -> int:
    """The capacity factor at which no expert can drop a token:
    ``capacity(T) >= T`` for every T, each token taking K distinct
    experts."""
    return -(-cfg.n_experts // cfg.top_k)


def moe_serve(dev, arch: str, layers, batch: int, prompt: int, cache: int,
              smoke: bool = False, dtype=None) -> dict:
    cfg = serve_config(arch, layers, smoke, dtype)
    return lm_serve(dev, cfg, batch, prompt, cache,
                    check_cfg=cfg.with_(capacity_factor=no_drop_cf(cfg)))


def moe_adafactor(dev, arch: str, smoke: bool, layers, steps: int,
                  batch: int, seq: int, lr: float) -> dict:
    """``steps`` steps of ``launch.train``'s ``train_step`` with
    ``build_optimizer("adafactor", lr)`` on ``arch`` (cut to ``layers``),
    on its token stream from seed 0: a finite loss at every step and the
    step-0 batch's loss lower after the steps; Adafactor launches no
    kernel (counts zeroed just before, read just after)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.optim import build_optimizer

    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = train.cut_depth(cfg, layers)
    reset_peak(dev)
    model = build_model(cfg)
    opt = build_optimizer("adafactor", lr)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)
    rng = np.random.default_rng(0)
    first = train.step_batch(np.random.default_rng(0), cfg, batch, seq, dev)
    losses, step_s = [], []
    zero_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, loss = train.train_step(
            model, opt, params, state,
            train.step_batch(rng, cfg, batch, seq, dev))
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    launches = read_counts()
    with torch.no_grad():
        again = float(model.loss(params, first)[0])
    rec = {"arch": arch, "n_layers": cfg.n_layers,
           "n_params": count_params(params), "dtype": cfg.param_dtype,
           "optimizer": opt.name, "lr": lr, "steps": steps,
           "tokens_per_step": batch * (seq - 1), "losses": losses,
           "step_s": step_s,
           "step_ms": statistics.median(step_s[1:] or step_s) * 1e3,
           "step0_batch_loss_after": again, "launches": launches,
           "peak_gb": peak_gb(dev)}
    del params, state
    if not all(np.isfinite(losses)):
        raise AssertionError(f"moe adafactor: non-finite loss {losses}")
    if not again < losses[0]:
        raise AssertionError(f"moe adafactor: the step-0 batch's loss went "
                             f"from {losses[0]} to {again}")
    if any(launches.values()):
        raise AssertionError(f"moe adafactor: launches {launches}")
    return rec


def smoke_train_card_cpu(dev, argv) -> dict:
    """``launch.train.main`` on ``argv`` on the card and on the CPU from
    one set of params: a ``--steps 0`` run on the CPU checkpoints its
    init, and each run resumes from a copy of it (a generator draws other
    values on the card). Each step's loss within ``SMOKE_TRAIN_RTOL``
    (relative) card against CPU, the optimizer's state through the
    checkpoint and back."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    runs = {}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        init = os.path.join(tmp, "init")
        train.main([*argv, "--steps", "0", "--ckpt-dir", init,
                    "--device", "cpu"])
        for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
            ck = os.path.join(tmp, name)
            shutil.copytree(init, ck)
            runs[name] = train.main([*argv, "--ckpt-dir", ck, "--resume",
                                     "--device", str(where)])
    card, cpu = runs["card"]["losses"], runs["cpu"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    rec = {"run": " ".join(argv), "losses_card": card, "losses_cpu": cpu,
           "loss_rel_max": rel, "rtol": SMOKE_TRAIN_RTOL,
           "opt_state_keys": sorted(runs["cpu"]["opt_state"])}
    if not (len(card) == len(cpu) > 0 and rel <= SMOKE_TRAIN_RTOL):
        raise AssertionError(f"smoke train ({' '.join(argv)}): card vs CPU "
                             f"losses "
                             f"{card} / {cpu}")
    return rec


def moe_phase(dev, serve=None, fp32=None, train=None, adafactor_lr=None,
              smoke_train=MOE_SMOKE_TRAIN, fl=None,
              trace_argv=MOE_TRACE_ARGS) -> dict:
    """The MoE + MLA LM family on the card: DeepSeek-V2-Lite served uncut
    and Arctic's layer at published width (bf16), the fp32 check at
    DeepSeek's 3-layer cut; DeepSeek's cut trained through ``launch.train``
    (fused Adam) and through ``train_step`` with Adafactor; Arctic's smoke
    run with Adafactor card against CPU; the federated MoE example
    (``moe_serve``, ``lm_train``, ``moe_adafactor``,
    ``smoke_train_card_cpu``, ``lm_fl``). The sizes cut it for a
    rehearsal. One JSON line."""
    t0 = time.perf_counter()
    serve_rec = {arch: moe_serve(dev, arch, **kw)
                 for arch, kw in (serve or MOE_SERVE).items()}
    serve_rec["float32"] = moe_serve(dev, **(fp32 or MOE_FP32),
                                     dtype="float32")
    train_kw = dict(train or MOE_TRAIN)
    train_rec = lm_train(dev, **train_kw)
    ada_kw = {k: train_kw[k] for k in ("arch", "smoke", "layers", "steps",
                                       "batch", "seq")}
    ada_rec = moe_adafactor(dev, **ada_kw,
                            lr=adafactor_lr or MOE_ADAFACTOR_LR)
    smoke_rec = smoke_train_card_cpu(dev, smoke_train)
    fl_rec = lm_fl(dev, **(fl or MOE_FL), trace_argv=trace_argv,
                   phase="moe")
    rec = {"serve": serve_rec, "train": train_rec, "adafactor": ada_rec,
           "smoke_train": smoke_rec, "fl": fl_rec,
           "wall_s": time.perf_counter() - t0}
    emit("moe", **rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def train_adam_entry(train: dict, phase: str, dev) -> dict:
    """``fused_adam`` at a centralized ``launch.train`` run's one lane of
    every param (padded to the kernel's vector width), with its run's
    launches."""
    from repro_torch.kernels.fused_adam import VEC

    reset_peak(dev)
    n = train["n_params"]
    run = (f"{phase} phase: {train['arch']} ({train['n_layers']} layers) "
           f"launch.train, {train['steps']} steps")
    return adam_entry(f"fused_adam[{train['arch']}]", 1, 1, n + (-n) % VEC,
                      train["launches"]["fused_adam"], run, dev)


def moe_kernel_entries(rec: dict, dev) -> list:
    """The MoE phase's new shape: ``fused_adam`` at the centralized
    DeepSeek step's one lane of every param of the 3-layer cut."""
    return [train_adam_entry(rec["train"], "moe", dev)]


# ---------------------------------------------------------------------- ssm
# Mamba2-370M (48 L, 368,338,432 params) and Zamba2-2.7B (54 L, 2,435,782,560
# params, 4.87 GB in bf16) served uncut, 4 x 512 into 576, bf16, each decoded
# position against the full forward (the recurrent step and the prefill's
# state handoff against the chunked scan); fp32 for Mamba2 uncut (1.5 GB)
# and for Zamba2 cut to 12 layers (2 chunks; the 1e-3 check, not a fit)
# The bf16 decode of these stacks strays further from the full forward than
# LM_DECODE_RTOL's 5 %, in the reference itself: the decode step and the
# prefill round otherwise than the full forward (the conv an einsum over
# the window against the unrolled sum, dt * x in fp32 against bf16) and the
# random-init stack amplifies the difference with depth. The reference's
# own largest deviation (scripts/bf16_decode_drift.py, CPU, 2 x 64 tokens
# then 16 steps): Mamba2 1.90 / 2.80 / 4.51 % at 4 / 8 / 16 layers, Zamba2
# 2.25 / 3.49 % at 6 / 12, growing as about depth^0.6: ~9 % at 48 and 54
# layers. 15 % is that times 1.7, the headroom LM_DECODE_RTOL took over
# its ~3 % estimate; fp32 (1e-3) stays the tight check of the recurrence
# and the state handoff
SSM_DECODE_RTOL = {"bfloat16": 0.15, "float32": 1e-3}
SSM_SERVE = {"mamba2-370m": dict(layers=None, batch=4, prompt=512,
                                 cache=576),
             "zamba2-2.7b": dict(layers=None, batch=4, prompt=512,
                                 cache=576)}
SSM_FP32 = {"mamba2-370m": dict(layers=None, batch=4, prompt=512, cache=576),
            "zamba2-2.7b": dict(layers=12, batch=4, prompt=512, cache=576)}
# the family's point, a state that does not grow with S: Mamba2 at
# prefill_32k's length (its batch cut from 32 to 1), then 7 decode steps;
# the check's full forward runs 32,775 tokens (chunk 115: 285 chunks),
# the prefill 128 chunks of 256. Only Mamba2: Zamba2's einsum attention
# would hold [B, 32, S, S] fp32 logits at 32k
SSM_LONG = dict(arch="mamba2-370m", layers=None, batch=1, prompt=32768,
                cache=32776)
# training, 3 steps through the fused Adam: Mamba2 uncut at train_4k's
# length (its batch cut from 256 to 4); Zamba2 cut to 36 layers (6 chunks,
# 1,717,794,240 params: Qwen3-1.7B's size, whose Adam step peaked at
# 48-51 GB; all 54 layers, 2.44 B, would need ~70 GB before activations)
SSM_TRAIN = {"mamba2-370m": dict(smoke=False, layers=None, steps=3, batch=4,
                                 seq=4096),
             "zamba2-2.7b": dict(smoke=False, layers=36, steps=3, batch=4,
                                 seq=1024)}
SSM_SMOKE_TRAIN = tuple(("--arch", arch, "--smoke", "--steps", "4",
                         "--batch", "4", "--seq", "64")
                        for arch in ("mamba2-370m", "zamba2-2.7b"))
# the federated SSM and hybrid LMs: the example at its container size (the
# arch's smoke config, vocabulary 256), as the example runs it by default
SSM_FL = tuple(dict(arch=arch, clients=12, rounds=3, data_vocab=256,
                    full=False) for arch in ("mamba2-370m", "zamba2-2.7b"))
SSM_TRACE_ARGS = tuple(("--arch", arch, "--clients", "12", "--rounds", "3")
                       for arch in ("mamba2-370m", "zamba2-2.7b"))


def ssm_serve(dev, arch: str, layers, batch: int, prompt: int, cache: int,
              smoke: bool = False, dtype=None) -> dict:
    """``lm_serve`` of ``arch`` (cut to ``layers``, in ``dtype``), with the
    scan's chunk of the prefill and of the check's full forward."""
    from repro_torch.models.ssm import chunk_for

    cfg = serve_config(arch, layers, smoke, dtype)
    rec = lm_serve(dev, cfg, batch, prompt, cache,
                   decode_rtol=SSM_DECODE_RTOL)
    rec["chunk_prefill"] = chunk_for(cfg, prompt)
    rec["chunk_full_forward"] = chunk_for(cfg, cache - 1)
    return rec


def ssm_phase(dev, serve=None, fp32=None, long=None, train=None,
              smoke_train=SSM_SMOKE_TRAIN, fl=None,
              trace_argv=SSM_TRACE_ARGS) -> dict:
    """The SSM and hybrid LM families on the card: Mamba2 and Zamba2
    served uncut in bf16, the fp32 checks (Mamba2 uncut, Zamba2's 12-layer
    cut), Mamba2 at a 32,768-token prompt; Mamba2 uncut and Zamba2's
    36-layer cut trained through ``launch.train`` (fused Adam); both
    smoke runs card against CPU; both federated examples (``ssm_serve``,
    ``lm_train``, ``smoke_train_card_cpu``, ``lm_fl``). The sizes cut it
    for a rehearsal. One JSON line."""
    t0 = time.perf_counter()
    serve_rec = {
        "bfloat16": {arch: ssm_serve(dev, arch, **kw, dtype="bfloat16")
                     for arch, kw in (serve or SSM_SERVE).items()},
        "float32": {arch: ssm_serve(dev, arch, **kw, dtype="float32")
                    for arch, kw in (fp32 or SSM_FP32).items()}}
    long_rec = ssm_serve(dev, **(long or SSM_LONG), dtype="bfloat16")
    train_rec = {arch: lm_train(dev, arch, **kw)
                 for arch, kw in (train or SSM_TRAIN).items()}
    smoke_rec = {argv[1]: smoke_train_card_cpu(dev, argv)
                 for argv in smoke_train}
    fl_rec = {kw["arch"]: lm_fl(dev, **kw, trace_argv=argv, phase="ssm")
              for kw, argv in zip(fl or SSM_FL, trace_argv)}
    rec = {"serve": serve_rec, "long": long_rec, "train": train_rec,
           "smoke_train": smoke_rec, "fl": fl_rec,
           "wall_s": time.perf_counter() - t0}
    emit("ssm", **rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def ssm_kernel_entries(rec: dict, dev) -> list:
    """The SSM phase's new shape: ``fused_adam`` at the centralized
    Mamba2 step's one lane of every param (368,338,432 uncut)."""
    return [train_adam_entry(rec["train"]["mamba2-370m"], "ssm", dev)]


# -------------------------------------------------------------------- xattn
# Llama-3.2-Vision (32 self layers + 8 gated cross blocks, 9,775,157,256
# params, 19.55 GB in bf16) and SeamlessM4T-large-v2 (24 encoder + 24
# decoder layers, 2,034,784,256 params, 4.07 GB) served uncut, 4 x 512
# into 576, bf16: the VLM over random patches at all 1,601 positions, its
# gates set to VLM_GATE after init (drawn as zeros, a fresh VLM's cross
# attention adds nothing and a check at init would pass with it wrong);
# SeamlessM4T over 4 x 512 random frames. fp32: the VLM cut to 8 layers (2
# chunks, 3,231,797,250 params, 12.9 GB), SeamlessM4T uncut (8.1 GB)
VLM_GATE = 1.0
XATTN_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
XATTN_SERVE = {arch: dict(layers=None, batch=4, prompt=512, cache=576)
               for arch in XATTN_ARCHS}
XATTN_FP32 = {"llama-3.2-vision-11b": dict(layers=8, batch=4, prompt=512,
                                           cache=576),
              "seamless-m4t-large-v2": dict(layers=None, batch=4,
                                            prompt=512, cache=576)}
# training, 3 steps of 4 x 1,024 through the fused Adam (~28 B a param of
# bf16 params and grads and fp32 rows): the VLM cut to 4 layers (1 chunk,
# 2,141,237,249 params, ~60 GB; 8 layers would be ~90 GB), SeamlessM4T
# uncut (~57 GB plus its 256,206-entry logits)
XATTN_TRAIN = {"llama-3.2-vision-11b": dict(smoke=False, layers=4, steps=3,
                                            batch=4, seq=1024),
               "seamless-m4t-large-v2": dict(smoke=False, layers=None,
                                             steps=3, batch=4, seq=1024)}
XATTN_SMOKE_TRAIN = tuple(("--arch", arch, "--smoke", "--steps", "4",
                           "--batch", "4", "--seq", "64")
                          for arch in XATTN_ARCHS)


def xattn_serve(dev, arch: str, layers, batch: int, prompt: int, cache: int,
                smoke: bool = False, dtype=None) -> dict:
    """``lm_serve`` of ``arch`` (cut to ``layers``, in ``dtype``)."""
    return lm_serve(dev, serve_config(arch, layers, smoke, dtype), batch,
                    prompt, cache)


# the VLM's cross attention trained card against CPU, on the smoke config.
# launch.train feeds the reference's zero patches, under which the gates'
# drawn zeros leave every cross-attention leaf's grad at exactly 0 (cross
# K/V of zeros are zeros, tanh(0) = 0): the training runs above pass with
# cross attention's backward wrong. Here the gates are opened and the
# patches drawn
XATTN_CROSS_TRAIN = dict(arch="llama-3.2-vision-11b", steps=3, batch=4,
                         seq=64)


def cross_train_card_cpu(dev, arch: str, steps: int, batch: int,
                         seq: int) -> dict:
    """``steps`` steps of ``launch.train.train_step`` (the config's Adam:
    the fused kernel on the card, its plain version on the CPU) on
    ``arch``'s smoke config, on the card and on the CPU from one CPU init
    with every gate at ``VLM_GATE``, over the launcher's token stream with
    normal patches drawn after each batch's tokens. Each step's loss
    within ``SMOKE_TRAIN_RTOL`` (relative) card against CPU; each
    cross-attention leaf's Adam moments after the steps (``m`` a decaying
    sum of its grads, ``v`` of their squares) within ``SMOKE_TRAIN_RTOL``
    (relative L2) card against CPU, and ``m`` non-zero; each leaf moved on
    both. The moments are held rather than the update ``m / (sqrt(v) +
    eps)``: a grad within rounding of 0 can take the other sign on the
    other device, which flips its element's update by 2 lr."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import RavelSpec, tree_map
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import build_optimizer

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    opt = build_optimizer(cfg.optimizer, cfg.learning_rate)
    init = model.init(torch.Generator().manual_seed(0))
    init["layers"]["cross"]["xattn"]["gate"].fill_(VLM_GATE)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        b = train.step_batch(rng, cfg, batch, seq, "cpu")
        b["patches"] = torch.as_tensor(
            rng.normal(size=tuple(b["patches"].shape)), dtype=torch.float32)
        batches.append(b)
    runs = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda p: p.to(where, copy=True), init)
        state = opt.init(params)
        losses = []
        for b in batches:
            params, state, loss = train.train_step(
                model, opt, params, state,
                {k: v.to(where) for k, v in b.items()})
            losses.append(float(loss))
        spec = RavelSpec(params)
        xattn = params["layers"]["cross"]["xattn"]
        runs[name] = {
            "losses": losses,
            "moved": {k: float((v.cpu() - init["layers"]["cross"]["xattn"][k])
                               .abs().max()) for k, v in xattn.items()},
            **{m: spec.unravel(state[m][0].cpu(), restore_dtype=False)[
                "layers"]["cross"]["xattn"] for m in ("m", "v")}}
    card, cpu = runs["card"], runs["cpu"]
    leaves = list(cpu["m"])
    rec = {"arch": arch, "gate": VLM_GATE, "steps": steps,
           "tokens_per_step": batch * (seq - 1),
           "losses_card": card["losses"], "losses_cpu": cpu["losses"],
           "loss_rel_max": max(abs(a - b) / abs(b) for a, b in
                               zip(card["losses"], cpu["losses"])),
           "moments_rel_l2": {k: {m: float((card[m][k] - cpu[m][k]).norm()
                                           / cpu[m][k].norm())
                                  for m in ("m", "v")} for k in leaves},
           "m_norm_cpu": {k: float(cpu["m"][k].norm()) for k in leaves},
           "moved_card": card["moved"], "moved_cpu": cpu["moved"],
           "rtol": SMOKE_TRAIN_RTOL}
    if not rec["loss_rel_max"] <= SMOKE_TRAIN_RTOL:
        raise AssertionError(f"cross train: card vs CPU losses "
                             f"{card['losses']} / {cpu['losses']}")
    for k in leaves:
        if not (rec["m_norm_cpu"][k] > 0 and card["moved"][k] > 0
                and cpu["moved"][k] > 0):
            raise AssertionError(f"cross train: {k} took no grad or did not "
                                 f"move ({rec['m_norm_cpu'][k]}, "
                                 f"{card['moved'][k]}, {cpu['moved'][k]})")
        if not max(rec["moments_rel_l2"][k].values()) <= SMOKE_TRAIN_RTOL:
            raise AssertionError(f"cross train: {k}'s moments card vs CPU "
                                 f"{rec['moments_rel_l2'][k]}")
    return rec


def xattn_phase(dev, serve=None, fp32=None, train=None,
                smoke_train=XATTN_SMOKE_TRAIN,
                cross_train=XATTN_CROSS_TRAIN) -> dict:
    """The VLM and enc-dec LM families on the card: Llama-3.2-Vision and
    SeamlessM4T served uncut in bf16, the fp32 checks (the VLM's 8-layer
    cut, SeamlessM4T uncut); the VLM's 4-layer cut and SeamlessM4T trained
    through ``launch.train`` (fused Adam); both smoke runs card against
    CPU; the VLM's smoke config trained with its gates open over random
    patches, card against CPU (``xattn_serve``, ``lm_train``,
    ``smoke_train_card_cpu``, ``cross_train_card_cpu``). Neither
    family is federated: the reference's client adapter passes tokens
    alone. The sizes cut it for a rehearsal. One JSON line."""
    t0 = time.perf_counter()
    serve_rec = {
        "bfloat16": {arch: xattn_serve(dev, arch, **kw, dtype="bfloat16")
                     for arch, kw in (serve or XATTN_SERVE).items()},
        "float32": {arch: xattn_serve(dev, arch, **kw, dtype="float32")
                    for arch, kw in (fp32 or XATTN_FP32).items()}}
    train_rec = {arch: lm_train(dev, arch, **kw)
                 for arch, kw in (train or XATTN_TRAIN).items()}
    smoke_rec = {argv[1]: smoke_train_card_cpu(dev, argv)
                 for argv in smoke_train}
    cross_rec = cross_train_card_cpu(dev, **cross_train)
    rec = {"serve": serve_rec, "train": train_rec, "smoke_train": smoke_rec,
           "cross_train": cross_rec, "wall_s": time.perf_counter() - t0}
    emit("xattn", **rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def xattn_kernel_entries(rec: dict, dev) -> list:
    """The xattn phase's new shapes: ``fused_adam`` at each centralized
    step's one lane of every param (the VLM's 4-layer cut, SeamlessM4T
    uncut)."""
    entries = []
    for arch in rec["train"]:
        entries.append(train_adam_entry(rec["train"][arch], "xattn", dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return entries


# ------------------------------------------------------------------- launch
# the meta sweep's children, one a group of archs: the SSM and hybrid
# families trace their chunk loops (tens of seconds at 32k), so each
# group holds about a third of the sweep's host time
LAUNCH_SWEEP_GROUPS = (
    ("zamba2-2.7b",),
    ("mamba2-370m", "qwen3-1.7b", "granite-8b", "yi-6b"),
    ("qwen3-4b", "llama-3.2-vision-11b", "deepseek-v2-lite-16b",
     "arctic-480b", "seamless-m4t-large-v2"))
SUBQUADRATIC_ARCHS = ("mamba2-370m", "zamba2-2.7b")  # run long_500k
# (arch, shape, cut, overrides): the executed cells on the card's 1x1 mesh.
# decode_32k at 4 sequences: a decode step holds the caches it reads, each
# layer's out-of-place copy and their stack, 3 x 15 GB at 4 (8 would need
# 90 GB)
LAUNCH_CELLS = (
    ("qwen3-1.7b", "train_4k", dict(global_batch=1), dict(remat=True)),
    ("qwen3-1.7b", "prefill_32k", dict(global_batch=1, seq_len=8192), None),
    ("qwen3-1.7b", "decode_32k", dict(global_batch=4), None),
    ("qwen3-1.7b", "fl_round", dict(global_batch=8), None),
    ("mamba2-370m", "long_500k", {}, None))
LAUNCH_SMOKE_ARCH = "qwen3-1.7b"
# kind -> (seq_len, global_batch) of the smoke cells run card against CPU
LAUNCH_SMOKE_SHAPES = {"train": (16, 2), "prefill": (16, 2),
                       "decode": (16, 2), "flround": (0, 3)}
LAUNCH_SMOKE_RTOL = 1e-5       # relative L2 of each output, card vs CPU
MOMENTUM_SHAPE = (128, 582_656)   # the main path's cohort rows [Kp, W]
MOMENTUM_STEPS = 4
MOMENTUM_RTOL = 1e-6
BF16_ULP_PIECE = 1 << 24       # columns of the fp64 check at once


def start_meta_sweep(tmp: str, groups=LAUNCH_SWEEP_GROUPS, extra=()
                     ) -> dict:
    """Start the dry run's meta sweep on the abstract 16x16 mesh
    (``python -m repro_torch.launch.dryrun --cost-mode auto``: every cell
    of every arch traced on ``meta`` tensors, the ssm and hybrid families
    extrapolated from two depths), one child process a group of archs,
    all at once. The children see no card (``CUDA_VISIBLE_DEVICES``
    empty), take one thread each and write their records under ``tmp``.
    ``meta_sweep`` collects them; a child still running at exit is
    killed."""
    import atexit

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    started = {"tmp": tmp, "groups": groups, "t0": time.perf_counter(),
               "t0_wall": time.time(), "procs": []}
    atexit.register(_stop_meta_sweep, started)
    for i, archs in enumerate(groups):
        out = os.path.join(tmp, f"sweep{i}.jsonl")
        log = open(os.path.join(tmp, f"sweep{i}.log"), "w")
        started["procs"].append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ",".join(archs), "--multi-pod", "single", "--cost-mode",
             "auto", "--out", out, *extra], env=env, cwd=str(ROOT),
            stdin=subprocess.DEVNULL, stdout=log,
            stderr=subprocess.STDOUT), out, log))
    return started


def _stop_meta_sweep(started: dict) -> None:
    for proc, _, log in started["procs"]:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def meta_sweep(tmp: str, groups=LAUNCH_SWEEP_GROUPS, shapes=None,
               extra=(), timeout: float = 900.0,
               started: Optional[dict] = None) -> dict:
    """The meta sweep (``start_meta_sweep``), started here unless
    ``started`` is one already running, which then ran beside the card's
    phases. Checks the records: every child exits 0 (the dry run exits 1
    on any error record), every (arch, shape) has one record, the skipped
    cells are exactly the reference's (``long_500k`` of every arch but
    Mamba2 and Zamba2, by ``shape_supported``) and every other cell is
    ok; ``tmp`` is removed after, and a child still running when this
    returns or raises is killed. Returns the counts, the wall (from the
    start to the last child's exit, as this wait sees it) and one
    compact row a cell."""
    import shutil

    started = started or start_meta_sweep(tmp, groups, extra)
    try:
        rec = _check_meta_sweep(started, shapes, timeout)
    finally:
        _stop_meta_sweep(started)
        shutil.rmtree(started["tmp"], ignore_errors=True)
    return rec


def _check_meta_sweep(started: dict, shapes, timeout: float) -> dict:
    from repro_torch.configs.base import SHAPES

    procs, t0 = started["procs"], started["t0"]
    archs = [a for g in started["groups"] for a in g]
    recs, end = [], 0.0
    for proc, out, log in procs:
        rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        log.flush()
        if rc:
            tail = Path(log.name).read_text()[-3000:]
            raise AssertionError(f"meta sweep child exited {rc}:\n{tail}")
        # a child's last write ends its work, on the host's clock
        end = max(end, os.path.getmtime(log.name), os.path.getmtime(out))
        recs += [json.loads(l) for l in Path(out).read_text().splitlines()]
    shapes = list(shapes or SHAPES)
    want_skip = {(a, "long_500k") for a in archs
                 if a not in SUBQUADRATIC_ARCHS and "long_500k" in shapes}
    cells = {(a, s) for a in archs for s in shapes}
    got = collections.Counter((r["arch"], r["shape"]) for r in recs)
    if set(got) != cells or max(got.values()) != 1:
        raise AssertionError(f"meta sweep: records for {sorted(got)}, "
                             f"wanted one for each of {sorted(cells)}")
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    errors = [r for r in recs if r["status"] == "error"]
    if errors or skipped != want_skip:
        raise AssertionError(f"meta sweep: {len(errors)} errors "
                             f"({[r.get('error') for r in errors][:3]}), "
                             f"skipped {sorted(skipped)}, the reference "
                             f"skips {sorted(want_skip)}")
    rows = [{"arch": r["arch"], "shape": r["shape"], "kind": r["kind"],
             "probe_depths": r.get("probe_depths"),
             "flops_global": r["flops_global"],
             "bytes_global": r["bytes_global"],
             "model_flops_global": r["model_flops_global"],
             "total_params": r["total_params"],
             "argument_bytes_per_device": r["argument_bytes_per_device"],
             "fused_adam": r["kernel_traffic"].get("fused_adam"),
             "build_s": r["compile_s"], "trace_s": r["unroll_compile_s"]}
            for r in recs if r["status"] == "ok"]
    return {"mesh": "16x16", "cost_mode": "auto", "n_ok": len(rows),
            "n_skipped": len(skipped), "n_error": 0,
            "skipped": sorted(f"{a}:{s}" for a, s in skipped),
            "children": len(procs), "wall_s": end - started["t0_wall"],
            "cells": rows}


def aggregate_check(updates, weights, out,
                    piece: int = BF16_ULP_PIECE) -> dict:
    """The bf16 aggregate against an fp64 weighted sum of the same
    updates, taken on their device ``piece`` columns at a time. Each
    element may stray one bf16 ulp at the sum (2^(floor(log2|sum|) - 7),
    the cast's rounding) plus the fp32 summation's error bound, K * 2^-24
    * sum_k |w_k x_k|: where the K terms nearly cancel, the fp32 sum's
    own error is many ulps of the small result. Returns the largest
    error over its bound (``bound_ratio_max``, <= 1 to pass) and the
    count of elements past one ulp at the sum alone."""
    from repro_torch.kernels.ops import tree_leaves

    w = weights.to(torch.float64)
    K = w.shape[0]
    worst, over, n = 0.0, 0, 0
    for x, o in zip(tree_leaves(updates), tree_leaves(out)):
        xf, of = x.reshape(x.shape[0], -1), o.reshape(-1)
        for c in range(0, of.numel(), piece):
            terms = xf[:, c:c + piece].to(torch.float64) * w[:, None]
            ref = terms.sum(dim=0)
            ulp = torch.exp2(torch.floor(torch.log2(
                ref.abs().clamp_min(2.0 ** -126))) - 7)
            err = (of[c:c + piece].to(torch.float64) - ref).abs()
            bound = ulp + K * 2.0 ** -24 * terms.abs().sum(dim=0)
            worst = max(worst, float((err / bound).max()))
            over += int((err > ulp).sum())
            n += ref.numel()
    return {"bound_ratio_max": worst, "n_past_one_ulp": over, "n": n}


def launch_cell(dev, arch: str, shape: str, cut: dict, overrides) -> dict:
    """One cell through ``launch.dryrun.execute_cell`` on ``dev`` (the
    card's 1x1 mesh), cut as ``cut`` names: the run's FLOPs equal to its
    meta trace's (checked inside), every output finite, the train step
    one ``fused_adam`` launch and no other kernel (the timed run, by the
    counters), the FL round's aggregate within one bf16 ulp of an fp64
    weighted sum on the card, plus the fp32 sum's error bound
    (``aggregate_check``). One JSON line: time, peak GB, counted FLOPs
    and bytes, model FLOPs at the cut, the bound, MFU, the cut."""
    from repro_torch.launch import dryrun

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = dryrun.execute_cell(arch, shape, device=dev, overrides=overrides,
                              verbose=False, seed=SEED, **cut)
    if rec["status"] != "ok":
        raise AssertionError(f"launch cell {arch} x {shape}: "
                             f"{rec.get('error')}\n{rec.get('traceback')}")
    args, out = rec.pop("args"), rec.pop("outputs")
    want = {"fused_adam": 1 if rec["kind"] == "train" else 0}
    others = {k: v for k, v in rec["kernel_launches"].items()
              if k not in want}
    if any(rec["kernel_launches"][k] != n for k, n in want.items()) \
            or any(others.values()):
        raise AssertionError(f"launch cell {arch} x {shape}: launches "
                             f"{rec['kernel_launches']}, wanted {want}")
    agg = aggregate_check(*args, out) if rec["kind"] == "flround" else None
    if agg is not None and not agg["bound_ratio_max"] <= 1.0:
        raise AssertionError(f"launch cell {arch} x {shape}: the aggregate "
                             f"strays from the fp64 sum: {agg}")
    del args, out
    line = {"arch": arch, "shape": shape, "kind": rec["kind"],
            "cut": rec["cut"], "overrides": overrides,
            "step_ms": rec["step_s"] * 1e3,
            "peak_gb": (rec["peak_memory_per_device"] or 0) / 1e9,
            "flops": rec["card_flops"], "meta_flops": rec["flops_global"],
            "bytes": rec["bytes_global"],
            "model_flops": rec["model_flops_global"],
            "useful_ratio": rec["useful_ratio"],
            "bound_ms": rec["step_time_s"] * 1e3,
            "compute_ms": rec["compute_s"] * 1e3,
            "memory_ms": rec["memory_s"] * 1e3,
            "bottleneck": rec["bottleneck"], "mfu": rec["mfu"],
            "measured_mfu": rec["measured_mfu"],
            "launches": rec["kernel_launches"],
            "kernel_traffic": rec["kernel_traffic"],
            "total_params": rec["total_params"],
            "argument_gb": rec["argument_bytes_per_device"] / 1e9,
            "trace_s": rec["unroll_compile_s"], "aggregate_check": agg}
    emit("launch_cell", **line)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line


def _to(args: tuple, dev) -> tuple:
    """A step's arguments on ``dev``: every tensor of each argument's tree
    but a 0-d one (a decode step's host write index)."""
    from repro_torch.kernels.ops import tree_map
    return tuple(tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                          and t.dim() else t, a) for a in args)


def rel_l2(got, want) -> float:
    """Relative L2 distance over every floating leaf of a tree, in fp64;
    an integer leaf must be equal (else inf)."""
    from repro_torch.kernels.ops import tree_leaves

    num = den = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if not isinstance(a, torch.Tensor) or not a.is_floating_point():
            if (int(a) if not isinstance(a, torch.Tensor)
                    else a.cpu().tolist()) != (
                    int(b) if not isinstance(b, torch.Tensor)
                    else b.cpu().tolist()):
                return float("inf")
            continue
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5 if den else num ** 0.5


def launch_smoke_card_cpu(dev, arch: str = LAUNCH_SMOKE_ARCH,
                          shapes=LAUNCH_SMOKE_SHAPES) -> dict:
    """Each cell kind's step at ``arch``'s smoke config on the card and on
    the CPU from the same arguments (``Cell.make_args`` on the CPU, moved
    to the card): every output (the loss, the params, the optimizer
    state; the logits tail and the caches; the aggregate) within
    ``LAUNCH_SMOKE_RTOL`` relative L2; the train step one ``fused_adam``
    launch on the card."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.launch.steps import build_cell

    smoke = get_config(arch, smoke=True)
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
          if f.name != "name"}
    out = {}
    for kind, (seq, batch) in shapes.items():
        cell = build_cell(arch, ShapeConfig(f"smoke_{kind}", seq, batch,
                                            kind), make_card_mesh(),
                          overrides=ov)
        args = cell.make_args("cpu", seed=SEED)
        card_args = _to(args, dev)
        want = cell.fn(*args)
        zero_counts()
        got = cell.fn(*card_args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = read_counts()
        on = {t.device.type for t in tree_leaves(list(got) if isinstance(
            got, tuple) else got) if isinstance(t, torch.Tensor)}
        if on != {dev.type}:
            raise AssertionError(f"launch smoke {kind}: outputs on {on}")
        parts = (("params", "opt_state", "loss") if kind == "train" else
                 ("logits", "caches") if kind in ("prefill", "decode")
                 else ("aggregate",))
        pairs = zip(got, want) if len(parts) > 1 else [(got, want)]
        rels = {name: rel_l2(a, b) for name, (a, b) in zip(parts, pairs)}
        rec = {"rel_l2": rels, "fused_adam": launches["fused_adam"]}
        if max(rels.values()) > LAUNCH_SMOKE_RTOL:
            raise AssertionError(f"launch smoke {kind}: card vs CPU {rels}")
        if launches["fused_adam"] != (1 if kind == "train" else 0):
            raise AssertionError(f"launch smoke {kind}: fused_adam launched "
                                 f"{launches['fused_adam']} times")
        out[kind] = rec
    return {"arch": arch, "rtol": LAUNCH_SMOKE_RTOL, "kinds": out}


def momentum_card_cpu(dev, shape=MOMENTUM_SHAPE,
                      steps: int = MOMENTUM_STEPS) -> dict:
    """``build_optimizer("momentum")``'s cohort step on ``[Kp, W]`` rows
    on the card and on the CPU from the same rows and grads (drawn on the
    card, copied), lanes of 0 to ``steps`` steps: params and ``m`` within
    ``MOMENTUM_RTOL`` of the CPU's (max abs over max abs), bit-equal or
    not as found; every lane of 0 steps untouched on the card."""
    from repro_torch.optim import build_optimizer

    Kp, W = shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lane_steps = torch.arange(Kp, dtype=torch.int32) % (steps + 1)
    flat = torch.randn((Kp, W), generator=gen, device=dev)
    flat0 = flat.clone()
    cpu = flat.cpu()
    opt = build_optimizer("momentum", 1e-2)
    st, st_cpu = opt.cohort_init(flat), opt.cohort_init(cpu)
    t_card = 0.0
    for s in range(steps):
        g = torch.randn((Kp, W), generator=gen, device=dev)
        g_cpu = g.cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        opt.cohort_step(flat, st, g, lane_steps.to(dev), s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_card += time.perf_counter() - t0
        opt.cohort_step(cpu, st_cpu, g_cpu, lane_steps, s)
    res = {}
    for name, a, b in (("params", flat, cpu), ("m", st["m"], st_cpu["m"])):
        a = a.cpu()
        res[name] = {"bit_equal": bool(torch.equal(a, b)),
                     "max_abs_diff": float((a - b).abs().max()),
                     "rel": float((a - b).abs().max() / b.abs().max())}
    idle = lane_steps.to(dev) == 0
    untouched = bool(torch.equal(flat[idle], flat0[idle]))
    rec = {"shape": [Kp, W], "steps": steps, "rtol": MOMENTUM_RTOL,
           "lanes_idle": int(idle.sum()), "idle_untouched": untouched,
           "card_step_ms": t_card / steps * 1e3, **res}
    if not untouched or max(r["rel"] for r in res.values()) > MOMENTUM_RTOL:
        raise AssertionError(f"momentum card vs CPU: {rec}")
    return rec


def launch_phase(dev, cells=LAUNCH_CELLS, smoke=None, momentum=None,
                 sweep=None, sweep_dir=None,
                 started: Optional[dict] = None) -> dict:
    """The launch tooling on the card: the executed cells on the 1x1 mesh
    (``launch_cell``, each its own line), the smoke cells card against
    CPU, momentum card against CPU, then the meta sweep (``meta_sweep``):
    the one ``started`` earlier, which ran beside the card's phases, or
    else one started now (its keyword arguments ``sweep``, in
    ``sweep_dir`` or a new folder). The sizes cut it for a rehearsal. One
    JSON line."""
    import tempfile

    t0 = time.perf_counter()
    cells_rec = [launch_cell(dev, *c) for c in cells]
    smoke_rec = launch_smoke_card_cpu(dev, **(smoke or {}))
    mom_rec = momentum_card_cpu(dev, **(momentum or {}))
    sweep_rec = meta_sweep(sweep_dir or tempfile.mkdtemp(
        prefix="chip_smoke_sweep_"), started=started, **(sweep or {}))
    rec = {"cells": [f"{c['arch']}:{c['shape']}" for c in cells_rec],
           "smoke_card_cpu": smoke_rec, "momentum": mom_rec,
           "meta_sweep": sweep_rec, "wall_s": time.perf_counter() - t0}
    emit("launch", **rec)
    rec["cell_records"] = cells_rec
    return rec


# -------------------------------------------------------------------- sweep
# the sweep's columns that the host decides (numpy RNG and simulated time);
# the others follow the accuracies, which card and CPU draw differently
SWEEP_HOST_COLUMNS = (
    "sweep", "dataset", "scenario", "strategy", "seed", "concurrency_ratio",
    "data_plane", "fault_profile", "traffic_profile", "rounds",
    "sim_time_s", "cold_starts", "cold_start_ratio",
    "cold_start_reduction_vs_fedavg", "cost_usd", "cost_vs_fedavg",
    "p50_round_latency_s", "p99_round_latency_s", "cost_per_round_usd",
    "n_invocations", "n_failures", "n_retries", "n_quarantined", "error")
SWEEP_ACC_COLUMNS = ("target_acc", "time_to_target_s", "speedup_vs_fedavg",
                     "final_acc", "best_acc")


def timed_sweep(spec, dev, workers: int = 1) -> tuple:
    """``run_sweep(spec)`` on ``dev`` with the kernel counts zeroed just
    before and read just after. On the CPU with more than one worker each
    op takes one thread (restored after), so that the cells, not the ops,
    share the cores. Returns (table, wall s, launches)."""
    from repro_torch.sweep import run_sweep
    threads = torch.get_num_threads()
    if dev.type == "cpu" and workers > 1:
        torch.set_num_threads(1)
    zero_counts()
    t0 = time.perf_counter()
    try:
        table = run_sweep(spec, max_workers=workers, device=dev)
    finally:
        torch.set_num_threads(threads)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return table, time.perf_counter() - t0, read_counts()


# cells run on this many threads: the bench-scale ablation's four cells
# side by side (1 and 2 workers give the same table; the smoke check)
SWEEP_WORKERS = {"dataplane_ablation": 4}
# BENCH_SCALE's 48 rounds halved: the script passed 1,000 s on the archive
# with the mesh phase's split reference (1,108.7 s on one H100 host)
SWEEP_ABLATION_ROUNDS = 24


def sweep_specs() -> dict:
    """The presets the sweep phase runs: ``smoke``; ``paper_tables`` (all
    four datasets on their proxies) at ``SMOKE_SCALE`` with ``fedavg`` and
    ``apodotiko``; and at their own scales ``chaos`` (fault profiles,
    recovery armed; ``SMOKE_SCALE``), ``production_load`` (traffic
    profiles; ``PROD_SCALE``) and ``dataplane_ablation`` (device and host
    data planes; ``BENCH_SCALE``, its rounds cut to
    ``SWEEP_ABLATION_ROUNDS``)."""
    from dataclasses import replace

    from repro_torch.sweep import SMOKE_SCALE, get_preset

    ablation = get_preset("dataplane_ablation")

    return {"smoke": get_preset("smoke"),
            "paper_tables": replace(get_preset("paper_tables"),
                                    strategies=("fedavg", "apodotiko"),
                                    scale=SMOKE_SCALE),
            "chaos": get_preset("chaos"),
            "production_load": get_preset("production_load"),
            "dataplane_ablation": replace(ablation, scale=replace(
                ablation.scale, rounds=SWEEP_ABLATION_ROUNDS))}


def plane_twins_equal(table) -> bool:
    """The data-plane ablation's own claim: each host-plane cell's host
    columns (all but ``data_plane``) equal its device-plane twin's."""
    cols = [c for c in SWEEP_HOST_COLUMNS if c != "data_plane"]
    by_plane = collections.defaultdict(list)
    for r in table.rows:
        by_plane[r["data_plane"]].append([r[c] for c in cols])
    return len(by_plane) == 2 and by_plane["device"] == by_plane["host"]


def sweep_phase(dev) -> dict:
    """The sweep engine on the card against the same sweep on the CPU, for
    each of ``sweep_specs``. The host columns (rounds, invocations, cold
    starts, cost, simulated time, failures, retries) must be equal card
    against CPU; the accuracies are printed side by side, not held (the
    card's generator draws other minibatches). Under deterministic
    algorithms the ``smoke`` table on the card must be the same to the byte
    for one and two workers. In ``dataplane_ablation`` each host-plane
    cell's host columns must equal its device-plane twin's, on both sides.
    No cell may fail (no ``error`` row), every card sweep must launch
    ``staleness_agg`` and ``fused_adam``, and the CPU sweeps none."""
    specs = sweep_specs()
    out = {}
    for name, spec in specs.items():
        workers = SWEEP_WORKERS.get(name, 1)
        rec = {"cells": spec.n_runs, "scale": asdict(spec.scale),
               "workers": workers}
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(name == "smoke")
        try:
            card, rec["card_wall_s"], rec["card_launches"] = timed_sweep(
                spec, dev, workers)
            if name == "smoke":
                pair, rec["card_2_workers_wall_s"], _ = timed_sweep(
                    spec, dev, workers=2)
                rec["serial_equals_2_workers"] = (
                    card.to_markdown() == pair.to_markdown())
        finally:
            torch.use_deterministic_algorithms(was)
        cpu, rec["cpu_wall_s"], cpu_launches = timed_sweep(
            spec, torch.device("cpu"), workers)
        if len(spec.data_planes) > 1:
            rec["planes_equal"] = all(plane_twins_equal(t)
                                      for t in (card, cpu))
        rows = []
        for a, b in zip(card.rows, cpu.rows):
            rows.append({**{c: a[c] for c in SWEEP_HOST_COLUMNS},
                         **{f"{c}_card": a[c] for c in SWEEP_ACC_COLUMNS},
                         **{f"{c}_cpu": b[c] for c in SWEEP_ACC_COLUMNS}})
        rec["host_columns_equal"] = all(
            {c: a[c] for c in SWEEP_HOST_COLUMNS}
            == {c: b[c] for c in SWEEP_HOST_COLUMNS}
            for a, b in zip(card.rows, cpu.rows))
        emit("sweep_rows", preset=name, rows=rows)
        emit("sweep", preset=name, **rec)
        errors = [r["error"] for r in card.rows + cpu.rows if r["error"]]
        if errors:
            raise AssertionError(f"sweep {name}: cells failed: {errors}")
        if not rec["host_columns_equal"]:
            raise AssertionError(f"sweep {name}: host columns differ card "
                                 "vs cpu")
        if rec.get("planes_equal") is False:
            raise AssertionError(f"sweep {name}: a host-plane cell's host "
                                 "columns differ from its device twin's")
        if rec.get("serial_equals_2_workers") is False:
            raise AssertionError(f"sweep {name}: the table differs for 1 "
                                 "and 2 workers")
        if min(rec["card_launches"][k]
               for k in ("staleness_agg", "fused_adam")) <= 0 or any(
                   cpu_launches.values()):
            raise AssertionError(f"sweep {name}: launches card "
                                 f"{rec['card_launches']} cpu {cpu_launches}")
        out[name] = rec
    return out


# ----------------------------------------------------------------- profiles
# the chaos preset's recovery layer (sweep/presets.py), armed on the
# Scheduler's fault runs; it is Scheduler-only, so the cross-engine pairs
# run without it, as the reference's chaos harness does
CHAOS_RECOVERY = dict(retry_budget=8, invocation_timeout=300.0,
                      quarantine_threshold=3)
FAULT_RUNS = ("crash-heavy", "outage-window", "lossy-network")
TRAFFIC_RUNS = ("steady-churn", "diurnal", "flash-crowd", "trace-demo")
# the phases each fault profile strikes in (failures_by_phase keys)
FAULT_PHASES = {"crash-heavy": ("startup", "train", "upload"),
                "outage-window": ("outage",), "lossy-network": ("loss",)}
# a traffic profile under SCAFFOLD whose leaves (its trace's oldest
# members) take clients that trained, so that their variate rows are zeroed
SCAFFOLD_TRAFFIC = "trace-demo"
PROFILE_ROUNDS = 2
# Simulated seconds cost no wall time, so the step time places the
# profiles' events inside 2 paper-width rounds. At 4.0 s a step (5x the
# sweep's MNIST calibration, 0.8 s) the pairs' 2 rounds span about 550 s:
# outage-window's first window (150-400 s) strikes, steady-churn's first
# departure and trace-demo's leaves (210 s) land, the flash crowd (60 s)
# leaves again. The recovery runs take 2.0 s a step: at 4.0 the preset's
# 300 s invocation timeout would kill nearly every invocation, at 2.0 it
# kills the slowest, so timeouts, retries and the outage all fire. The
# trace-demo megastep run takes 0.5 s a step: a round of the megastep
# config is then about 80 s, so its segments (joins at 90 s, leaves at
# 210 s, joins at 300 s) fall between its fused rounds.
PROFILE_STEP_TIMES = {"recovery": 2.0, "faults": 4.0, "traffic": 4.0,
                      "trace_megastep": 0.5}
TRACE_MEGA = dict(rounds=6, traffic_profile="trace-demo")
TRAFFIC_KEYS = ("n_traffic_joins", "n_traffic_leaves", "n_traffic_dropped",
                "traffic_segments_applied")
PLANE_ATOL = 1e-5            # tests/test_update_plane.py:231-234


def chaos_trace(engine):
    """``host_trace`` plus each invocation's fault attribution (phase,
    lost, timed out, cancelled): the reference chaos harness's trace."""
    hist, inv = host_trace(engine)
    return hist, inv, [(r.client_id, r.round, r.failed_phase, r.lost,
                        r.timed_out, r.cancelled)
                       for r in engine.platform.invocations]


def profile_cfg(rounds: int = PROFILE_ROUNDS, **over):
    """``paper_engine``'s config (the paper's MNIST setup at published
    width) at the sweep's calibrated MNIST step time
    (``sweep/runner.py`` ``BASE_STEP_TIME``, 0.8 s) unless ``over`` sets
    another, with ``over`` on top."""
    from repro_torch.core.services import FLConfig
    from repro_torch.sweep.runner import BASE_STEP_TIME
    return FLConfig(**{**dict(n_clients=200, clients_per_round=100,
                              rounds=rounds, strategy="apodotiko",
                              concurrency_ratio=0.3, local_epochs=5,
                              batch_size=10, optimizer="adam", lr=1e-3,
                              base_step_time=BASE_STEP_TIME["mnist"],
                              seed=SEED), **over})


def timed_run(eng) -> tuple:
    """``eng.run()`` with the kernel counts zeroed just before and read
    just after, and its wall time with the card drained. Returns (metrics,
    wall s per round, launches)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = eng.run()
    torch.cuda.synchronize()
    return m, (time.perf_counter() - t0) / max(len(eng.history), 1), \
        read_counts()


def profile_summary(eng, m: dict, wall_s: float, launches: dict) -> dict:
    return {"rounds": m["rounds"], "wall_s_per_round": wall_s,
            "n_invocations": m["n_invocations"],
            "n_failures": m["n_failures"],
            "failures_by_phase": m["failures_by_phase"],
            "n_retries": m["n_retries"], "n_timeouts": m["n_timeouts"],
            "n_quarantined": m["n_quarantined"],
            "n_cancelled": sum(bool(r.cancelled)
                               for r in eng.platform.invocations),
            **{k: m[k] for k in TRAFFIC_KEYS},
            "total_sim_time_s": m["total_time"],
            "megastep_fallback_reason": m["megastep_fallback_reason"],
            "launches": {k: launches[k]
                         for k in path_kernels(eng.cfg.strategy)}}


def check_struck(name: str, s: dict, recovered: bool = False) -> None:
    """A fault run must fail invocations in its profile's own phases, and
    with the recovery layer, retry or time out some."""
    if not any(s["failures_by_phase"].get(p, 0) > 0
               for p in FAULT_PHASES[name]) or \
            recovered and s["n_retries"] + s["n_timeouts"] <= 0:
        raise AssertionError(f"{name}: struck nothing in "
                             f"{FAULT_PHASES[name]}: "
                             f"{s['failures_by_phase']}, "
                             f"{s['n_retries']} retries, "
                             f"{s['n_timeouts']} timeouts")


def check_moved(name: str, counts: dict) -> None:
    """A traffic run must apply a segment with joins and with leaves (and
    flash-crowd drop arrivals past capacity)."""
    want = ["n_traffic_joins", "n_traffic_leaves",
            "traffic_segments_applied"]
    if name == "flash-crowd":
        want.append("n_traffic_dropped")
    if min(counts[k] for k in want) <= 0:
        raise AssertionError(f"{name}: traffic applied "
                             f"{ {k: counts[k] for k in TRAFFIC_KEYS} }")


def watch_variates(eng) -> dict:
    """Under SCAFFOLD, wrap ``eng._apply_traffic_segment``: after each
    segment the variate rows of the clients it removed must be zero.
    Returns a dict whose ``"zeroed"`` counts the removed clients whose row
    was not zero before (they had trained); a non-zero row left behind
    fails."""
    seen = {"zeroed": 0}
    apply = eng._apply_traffic_segment

    def wrapped(seg):
        idx = torch.as_tensor(
            [int(c) for c in seg.leaves
             if eng.db.has_client(int(c)) and int(c) < eng._c_cap],
            dtype=torch.long, device=eng.c_buf.device)
        trained = int(eng.c_buf[idx].ne(0).any(dim=1).sum())
        apply(seg)
        if bool(eng.c_buf[idx].ne(0).any()):
            raise AssertionError("a departed client's variate row is not "
                                 "zero")
        seen["zeroed"] += trained

    eng._apply_traffic_segment = wrapped
    return seen


def engine_pair(data, dev, model=None, **over) -> dict:
    """The poll-loop ``Controller`` and the ``Scheduler`` on one config at
    paper width under deterministic algorithms (restored after): chaos
    traces equal, params (and SCAFFOLD's variates) bit-equal, the counters
    equal, each run launching the path's kernels. Returns the Scheduler's
    summary and both walls."""
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import MnistCNN

    runs, zeroed = {}, {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for cls in (Controller, Scheduler):
            cfg = profile_cfg(**over)
            eng = cls(cfg, model or MnistCNN(), data,
                      list(paper_fleet(cfg.n_clients)), device=dev)
            if eng.c_buf is not None:
                zeroed[cls.__name__] = watch_variates(eng)
            runs[cls.__name__] = (eng, *timed_run(eng))
    finally:
        torch.use_deterministic_algorithms(was)
    (legacy, m_l, wall_l, n_l), (sched, m_s, wall_s, n_s) = \
        runs["Controller"], runs["Scheduler"]
    name = over.get("fault_profile") or over.get("traffic_profile")
    if chaos_trace(legacy) != chaos_trace(sched):
        raise AssertionError(f"{name}: Controller and Scheduler traces "
                             "differ")
    for key in ("total_time", "n_failures", "failures_by_phase",
                *TRAFFIC_KEYS):
        if m_l[key] != m_s[key]:
            raise AssertionError(f"{name}: {key} differs across engines")
    pairs = [(leaf, p, legacy.params[leaf])
             for leaf, p in sched.params.items()]
    if sched.c_buf is not None:
        pairs += [("c_global", sched.c_global, legacy.c_global),
                  ("c_buf", sched.c_buf, legacy.c_buf)]
    for leaf, a, b in pairs:
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name}: {leaf} differs across engines")
    kernels = path_kernels(sched.cfg.strategy)
    for launches in (n_l, n_s):
        if min(launches[k] for k in kernels) <= 0:
            raise AssertionError(f"{name}: launches {launches}")
    summary = {**profile_summary(sched, m_s, wall_s, n_s),
               "step_time_s": sched.cfg.base_step_time,
               "strategy": sched.cfg.strategy,
               "controller_wall_s_per_round": wall_l,
               "engines_bit_equal": True}
    if zeroed:
        n = {k: v["zeroed"] for k, v in zeroed.items()}
        if min(n.values()) <= 0 or len(set(n.values())) > 1:
            raise AssertionError(f"{name}: trained clients whose variate "
                                 f"rows a leave zeroed: {n}")
        summary["departed_variates_zeroed"] = n["Scheduler"]
    return summary


def plane_runs(data, dev, model=None, **size) -> tuple[dict, dict]:
    """``update_plane="blob"`` with ``data_plane="host"`` (the reference's
    equivalence oracles) against the device planes at paper width: host
    traces equal, params within ``PLANE_ATOL`` (the blob route sums the
    updates in pending order, the rows route in row order), and the byte
    counters non-zero on the oracle planes, 0 on the device planes.
    Returns (record, the oracle run's summary)."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import MnistCNN

    runs = {}
    for name, over in (("device", {}),
                       ("oracle", dict(update_plane="blob",
                                       data_plane="host"))):
        cfg = profile_cfg(**size, **over)
        eng = build_engine(cfg, model or MnistCNN(), data,
                           list(paper_fleet(cfg.n_clients)), device=dev)
        runs[name] = (eng, *timed_run(eng))
    (dev_eng, m_d, wall_d, n_d), (orc, m_o, wall_o, n_o) = \
        runs["device"], runs["oracle"]
    err = max(float((p - orc.params[k]).abs().max())
              for k, p in dev_eng.params.items())
    record = {
        "host_traces_equal": chaos_trace(dev_eng) == chaos_trace(orc),
        "params_max_abs_diff": err, "atol": PLANE_ATOL,
        **{f"{plane}_{key}": m[key] for plane, m in (("device", m_d),
                                                      ("oracle", m_o))
           for key in ("update_plane", "data_plane", "update_host_bytes",
                       "data_host_bytes", "data_resident_bytes")},
        "device_wall_s_per_round": wall_d, "oracle_wall_s_per_round": wall_o,
        "device_launches": n_d, "oracle_launches": n_o,
        "last_pending": orc.history[-1].n_aggregated,
        "oracle": profile_summary(orc, m_o, wall_o, n_o)}
    if not record["host_traces_equal"]:
        raise AssertionError("planes: host traces differ")
    if err > PLANE_ATOL:
        raise AssertionError(f"planes: params differ by {err}")
    if (m_d["update_host_bytes"], m_d["data_host_bytes"]) != (0, 0) or \
            min(m_o["update_host_bytes"], m_o["data_host_bytes"]) <= 0:
        raise AssertionError("planes: byte counters "
                             f"{m_d['update_host_bytes']} "
                             f"{m_d['data_host_bytes']} "
                             f"{m_o['update_host_bytes']} "
                             f"{m_o['data_host_bytes']}")
    for launches in (n_d, n_o):
        if min(launches[k] for k in path_kernels("apodotiko")) <= 0:
            raise AssertionError(f"planes: launches {launches}")
    return record, {"rounds": [{"n_aggregated": l.n_aggregated}
                               for l in orc.history],
                    "launches": n_o, "n_params": orc.spec.n_params,
                    "strategy": "apodotiko"}


def profiles_phase(data, dev, model=None, step_times=None, **size) -> dict:
    """Fault and traffic profiles and the oracle planes at the paper's
    MNIST width (``profile_cfg``), 2 rounds a run, at the step times of
    ``step_times`` (``PROFILE_STEP_TIMES`` by default): each fault profile
    on the Scheduler with the ``chaos`` preset's recovery layer, then the
    ``Controller`` against the ``Scheduler`` without it (``engine_pair``);
    each traffic profile through ``engine_pair``, and ``SCAFFOLD_TRAFFIC``
    once more under ``scaffold``; ``trace-demo`` fused against stepwise on
    the megastep config (``megastep_phase``); and ``plane_runs``. Every
    fault run must strike in its profile's phases (the recovery runs must
    also retry or time out), every traffic run and both trace-demo
    megastep runs must apply joins and leaves, and the SCAFFOLD run must
    zero departed clients' variate rows; in-flight invocations that
    leaves cancelled are counted. Any mismatch fails the phase. ``model``
    (MnistCNN by default), ``step_times`` and ``size`` (config fields) cut
    the runs for a rehearsal. Returns the record, with the plane run's
    numbers for the ``staleness_agg[pytree]`` entry under
    ``pytree_run``."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import MnistCNN

    steps = step_times or PROFILE_STEP_TIMES
    t_phase = time.perf_counter()
    record = {"rounds": PROFILE_ROUNDS, "recovery": CHAOS_RECOVERY,
              "step_times_s": steps, "faults": {}, "traffic": {}}
    for profile in FAULT_RUNS:
        cfg = profile_cfg(fault_profile=profile, **CHAOS_RECOVERY,
                          base_step_time=steps["recovery"], **size)
        eng = build_engine(cfg, model or MnistCNN(), data,
                           list(paper_fleet(cfg.n_clients)), device=dev)
        m, wall, launches = timed_run(eng)
        if m["fault_profile"] != profile or len(eng.history) != \
                PROFILE_ROUNDS:
            raise AssertionError(f"{profile}: {m['fault_profile']}, "
                                 f"{len(eng.history)} rounds")
        rec = {"recovery": profile_summary(eng, m, wall, launches),
               "engines": engine_pair(data, dev, model,
                                      fault_profile=profile,
                                      base_step_time=steps["faults"],
                                      **size)}
        check_struck(profile, rec["recovery"], recovered=True)
        check_struck(profile, rec["engines"])
        record["faults"][profile] = rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for profile, strategy in [(p, "apodotiko") for p in TRAFFIC_RUNS] + [
            (SCAFFOLD_TRAFFIC, "scaffold")]:
        key = profile if strategy == "apodotiko" else \
            f"{profile}[{strategy}]"
        rec = engine_pair(data, dev, model, traffic_profile=profile,
                          strategy=strategy,
                          base_step_time=steps["traffic"], **size)
        check_moved(key, rec)
        record["traffic"][key] = rec
    mega = megastep_phase(data, dev, model=model, order=("stepwise", "fused"),
                          emit_as="profiles_trace_demo",
                          base_step_time=steps["trace_megastep"],
                          **{**TRACE_MEGA, **size})
    record["trace_demo_megastep"] = {
        "fused_rounds": [r["megastep_rounds"] for r in mega["runs"]],
        "traffic": [{k: r[k] for k in TRAFFIC_KEYS} for r in mega["runs"]],
        "bit_equal": all(all(e.values()) for e in mega["bit_equal"].values())}
    for counts in record["trace_demo_megastep"]["traffic"]:
        check_moved("trace-demo megastep", counts)
    record["planes"], pytree_run = plane_runs(data, dev, model, **size)
    record["seconds"] = time.perf_counter() - t_phase
    emit("profiles", **record)
    return {**record, "pytree_run": pytree_run}


# --------------------------------------------------------------- durability
DUR_ROUNDS = 3                # the apodotiko golden run and its crashes
DUR_TOPK_ROUNDS = 2           # the apodotiko-topk golden run
DUR_CHILD = ROOT / "scripts" / "torch_durable_crash_child.py"
DUR_CHILD_CRASH = 6           # the SIGKILL child's crash point (records)
DUR_CI_LIMIT = 0.05           # the reference's journal overhead limit in
#                               CI (benchmarks/bench_round.py:1297-1300)


def durable_state(eng) -> dict:
    """What a resumed run must give back bit for bit: host trace, round
    log, clock, params (their bits), the store's free list and live rows
    (ids and bits), the generator, and on the columnar plane the fleet's
    host columns and device score state (booster included)."""
    live = [int(i) for i in eng.store.live_rows()]
    out = {"trace": host_trace(eng), "history": list(eng.history),
           "total_time": eng.loop.now,
           "params": {n: p.view(torch.int32).cpu()
                      for n, p in eng.params.items()},
           "free_list": list(eng.store._free), "live_rows": live,
           "rows": eng.store.gather(live).view(torch.int32).cpu(),
           "generator": eng.trainer.generator.get_state()}
    if eng.db.columnar:
        fs = eng.db.fleet
        out["fleet_host"] = {k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in fs.state_dict().items()}
        if fs._dev is not None:
            fs._flush_device()
            out["fleet_device"] = {
                c: getattr(fs._dev, c).cpu()
                for c in ("num", "den", "booster", "eligible", "ever")}
    return out


def unequal(got: dict, want: dict) -> list:
    """The keys of two ``durable_state`` dicts that differ."""
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or not same(got[k], want[k]))


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def crash_points(records: list) -> dict:
    """Two boundaries of a golden journal, as ``crash_after`` values (the
    count of records the killed run processes): the middle
    ``ResultLanded`` of the second round and the record right after the
    first ``round_close`` (the snapshot boundary). The script's time
    leaves the others to the CPU tests, which crash at every boundary."""
    landed = [r["q"] for r in records
              if r["k"] == "ResultLanded" and r["r"] == 1]
    closes = [r["q"] for r in records if r["k"] == "round_close"]
    if not landed or not closes:
        raise AssertionError("the golden journal has no ResultLanded in "
                             "round 2 or no round_close")
    return {"mid_round_2": landed[len(landed) // 2] + 1,
            "after_round_close": closes[0] + 2}


def resume_launches(eng, n_invocations: int, snap_round: int) -> dict:
    """The launches a resumed run must have made: one aggregate (and, for
    top-k, one selection) a round it re-executed from ``snap_round``, one
    Adam step a local step of each re-executed cohort's largest budget
    (one trainer call a (round, instant) of the invocations it added past
    the first ``n_invocations``)."""
    cohorts = collections.defaultdict(int)
    for r in eng.platform.invocations[n_invocations:]:
        key = (r.round, r.t_invoked)
        cohorts[key] = max(cohorts[key], step_budget(
            eng.data, r.client_id, eng.cfg.batch_size, eng.cfg.local_epochs))
    rounds = eng.db.round - snap_round
    want = {"staleness_agg": rounds, "fused_adam": sum(cohorts.values())}
    if eng.cfg.strategy == "apodotiko-topk":
        want["block_topk"] = rounds
    return want


def crash_and_resume(cfg, model, data, dev, k: int, gold: dict,
                     gold_journal: bytes) -> dict:
    """Kill a durable run after journal record ``k``, resume it on ``dev``
    (``resume_durable``, timed: truncate, validate, load, build, install)
    and run it to the end with every kernel count zeroed just before the
    resume and read just after. Returns its record, with ``equal``: the
    journal bytes and every ``durable_state`` key against the golden run's,
    and the launches against ``resume_launches``."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.durability import SimulatedCrash, resume_durable
    from repro_torch.faas.hardware import paper_fleet

    fleet = list(paper_fleet(cfg.n_clients))
    eng = build_engine(cfg, model, data, list(fleet), device=dev)
    eng.durability.crash_after = k
    try:
        eng.run()
        raise AssertionError(f"the run ended before its crash point {k}")
    except SimulatedCrash:
        pass
    del eng
    zero_counts()
    t0 = time.perf_counter()
    res = resume_durable(cfg, model, data, list(fleet), device=dev)
    resume_s = time.perf_counter() - t0
    snap_round, n_inv = res.db.round, len(res.platform.invocations)
    m = res.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    want = resume_launches(res, n_inv, snap_round)
    got = durable_state(res)
    journal_equal = read_bytes(os.path.join(
        cfg.checkpoint_dir, "journal.wal")) == gold_journal
    differ = unequal(got, gold) + ([] if journal_equal else ["journal"])
    return {"crash_after": k, "snapshot_round": snap_round,
            "journal_replayed": m["journal_replayed"],
            "resume_ms": resume_s * 1e3,
            "launches": {n: launches[n] for n in want},
            "launches_wanted": want, "differs": differ,
            "live_rows": len(got["live_rows"])}


def durable_cfg(strategy: str, rounds: int, root: str, **over):
    """``paper_cfg`` with ``durability="journal"`` in ``root``."""
    return paper_cfg(strategy, rounds, durability="journal",
                     checkpoint_dir=root, **over)


def timed_durable_run(cfg, model, data, dev) -> tuple:
    """(engine, metrics, wall s) of one run through ``build_engine``."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.faas.hardware import paper_fleet

    eng = build_engine(cfg, model, data, list(paper_fleet(cfg.n_clients)),
                       device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return eng, m, time.perf_counter() - t0


def snapshot_bytes(root: str) -> list:
    """Bytes of each snapshot kept in ``root``, from its manifest."""
    from repro_torch.durability import list_snapshots
    from repro_torch.durability.snapshot import MANIFEST, snapshot_dir
    out = []
    for seq in list_snapshots(root):
        with open(os.path.join(snapshot_dir(root, seq), MANIFEST)) as f:
            out.append(sum(v["size"] for v in json.load(f)["files"].values()))
    return out


def golden_crash_series(strategy: str, rounds: int, points, model, data,
                        dev, tmp: str, after_golden=None, **size) -> dict:
    """One golden durable run of ``strategy`` and a crash-and-resume at each
    boundary ``points(records)`` names (``after_golden()``, if given, is
    called between the two); each resumed run's directory is removed after
    its comparison, the golden one at the end. Returns (the series'
    record, the golden journal's bytes)."""
    import shutil

    from repro_torch.core.journal import Journal

    gold_dir = os.path.join(tmp, f"{strategy}-golden")
    eng, m, wall = timed_durable_run(
        durable_cfg(strategy, rounds, gold_dir, **size), model, data, dev)
    gold, gold_journal = durable_state(eng), read_bytes(
        os.path.join(gold_dir, "journal.wal"))
    records, _ = Journal.read(os.path.join(gold_dir, "journal.wal"))
    out = {"wall_s": wall, "rounds": len(eng.history),
           "snapshot_bytes": snapshot_bytes(gold_dir),
           "snapshot_ms": m["snapshot_s"] / max(m["n_snapshots"], 1) * 1e3,
           **{k: m[k] for k in ("journal_records", "journal_bytes",
                                "journal_fsyncs", "n_snapshots",
                                "durability_sync")},
           "live_rows": len(gold["live_rows"]), "crashes": {}}
    del eng
    shutil.rmtree(gold_dir)
    if after_golden is not None:
        after_golden()
    for name, k in points(records).items():
        root = os.path.join(tmp, f"{strategy}-{name}")
        out["crashes"][name] = crash_and_resume(
            durable_cfg(strategy, rounds, root, **size), model, data, dev,
            k, gold, gold_journal)
        shutil.rmtree(root)
        gc.collect()            # an engine and its manager hold each other
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out, gold_journal


def start_child(dev, tmp: str) -> tuple:
    """Start ``scripts/torch_durable_crash_child.py`` on ``dev`` under
    deterministic algorithms, armed to die by a real SIGKILL after journal
    record ``DUR_CHILD_CRASH``. It runs beside this process (its start-up,
    most of its time, overlaps the crash runs). Returns (the process, its
    start time, its checkpoint directory)."""
    kill_dir = os.path.join(tmp, "child-killed")
    proc = subprocess.Popen(
        [sys.executable, str(DUR_CHILD), kill_dir, "--crash-after",
         str(DUR_CHILD_CRASH), "--crash-mode", "sigkill", "--device",
         dev.type, "--deterministic"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), kill_dir


def sigkill_child(started: tuple, dev, tmp: str) -> dict:
    """Wait for the child of ``start_child``, which must have died by
    SIGKILL with ``DUR_CHILD_CRASH`` records on disk; then resume it in
    this process on ``dev`` and hold it to an in-process golden run of the
    child's config."""
    import importlib.util

    from repro_torch.core.journal import Journal
    from repro_torch.core.scheduler import build_engine
    from repro_torch.durability import resume_durable

    proc, t0, kill_dir = started
    _, err = proc.communicate(timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != -9:
        raise AssertionError(f"the child exited {proc.returncode}, not by "
                             f"SIGKILL: {err[-800:]}")
    spec = importlib.util.spec_from_file_location("torch_durable_crash_child",
                                                  DUR_CHILD)
    child = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(child)
    gold_dir = os.path.join(tmp, "child-golden")
    records, _ = Journal.read(os.path.join(kill_dir, "journal.wal"))
    gold_eng = build_engine(child.child_config(gold_dir),
                            *child.child_setup(), device=dev)
    gold_eng.run()
    res = resume_durable(child.child_config(kill_dir), *child.child_setup(),
                         device=dev)
    snap_round = res.db.round
    res.run()
    differ = unequal(durable_state(res), durable_state(gold_eng))
    if read_bytes(os.path.join(kill_dir, "journal.wal")) != read_bytes(
            os.path.join(gold_dir, "journal.wal")):
        differ.append("journal")
    return {"crash_after": DUR_CHILD_CRASH, "returncode": proc.returncode,
            "child_wall_s": child_s, "records_on_disk": len(records),
            "snapshot_round": snap_round, "device": str(res.device),
            "differs": differ}


def checkpoint_state(eng) -> dict:
    """What a database checkpoint restores: the round counter, the results,
    the client records (the fleet's host columns on the columnar plane),
    the params (their bits) and the pending update rows (ids, and bits cut
    to the model's params: another mesh pads rows to another width)."""
    live = sorted(r.update_row for r in eng.db.results if not r.aggregated)
    out = durable_state(eng)
    clients = out["fleet_host"] if eng.db.columnar else {
        c: asdict(r) for c, r in eng.db.clients.items()}
    rows = eng.store.gather(live)[:, :eng.spec.n_params].contiguous()
    return {"round": eng.db.round,
            "results": [asdict(r) for r in eng.db.results],
            "clients": clients, "params": out["params"],
            "pending_rows": live, "rows": rows.view(torch.int32).cpu()}


def checkpoint_resume(model, data, dev, tmp: str, engine: str = "legacy",
                      **over) -> tuple:
    """Database checkpoints: ``apodotiko`` on the ``engine`` with
    ``checkpoint_every=1`` for 2 rounds, its stragglers landed and one more
    ``checkpoint()`` (so the checkpoint holds live rows), then the engine's
    ``resume`` with ``rounds=3``: the round counter, client records,
    results, params and live update rows (ids and bits) equal the
    checkpoint's (``checkpoint_state``), and the resumed run finishes its
    round with one aggregate. ``over`` sets other fields (a size, a
    mesh). Returns (the record, the checkpoint's state); the checkpoint
    stays in ``tmp/checkpoint``."""
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.faas.hardware import paper_fleet

    cls = {"legacy": Controller, "scheduler": Scheduler}[engine]
    root = os.path.join(tmp, "checkpoint")
    cfg = paper_cfg("apodotiko", 2, engine=engine, checkpoint_every=1,
                    checkpoint_dir=root, **over)
    fleet = list(paper_fleet(cfg.n_clients))
    ctl = cls(cfg, model, data, list(fleet), device=dev)
    cadence, checkpoint = [], ctl.checkpoint

    def counted():
        cadence.append(ctl.db.round)
        checkpoint()

    ctl.checkpoint = counted
    ctl.run()
    while ctl.loop.step():      # land the stragglers: live rows to save
        pass
    mesh0 = ctl.mesh.counters() if ctl.mesh is not None else None
    t0 = time.perf_counter()
    checkpoint()
    save_s = time.perf_counter() - t0
    mesh_bytes = (ctl.mesh.counters()["mesh_host_bytes"]
                  - mesh0["mesh_host_bytes"] if mesh0 else 0)
    want = checkpoint_state(ctl)
    del ctl
    t0 = time.perf_counter()
    res = cls.resume(paper_cfg("apodotiko", 3, engine=engine,
                               checkpoint_dir=root, **over),
                     model, data, list(fleet), device=dev)
    resume_s = time.perf_counter() - t0
    got = checkpoint_state(res)
    zero_counts()
    m = res.run()
    launches = read_counts()
    return {"engine": engine, "mesh": m["mesh"], "cadence": cadence,
            "checkpoint_round": want["round"],
            "live_rows": len(want["pending_rows"]), "save_ms": save_s * 1e3,
            "save_mesh_host_bytes": mesh_bytes,
            "resume_ms": resume_s * 1e3, "differs": unequal(got, want),
            "resumed_rounds": m["rounds"], "final_round": res.db.round,
            "staleness_agg": launches["staleness_agg"]}, want


def check_checkpoint(rec: dict, where: str) -> None:
    """A ``checkpoint_resume`` record: every equality, the cadence, the
    round reached and one aggregate."""
    if rec["differs"] or rec["cadence"] != [1, 2] or \
            rec["final_round"] != 3 or rec["staleness_agg"] != 1:
        raise AssertionError(f"{where}: the checkpoint resume: {rec}")


def mesh_journal_check(mesh_journal: bytes, gold_journal: bytes,
                       mesh_cfg) -> dict:
    """A durable run's journal at a mesh against the same config's 1x1
    journal, record for record (``q``, ``k``, ``t``, ``r``, ``p`` and
    ``g``: nothing in a record depends on the params). The one exception
    is the genesis digest, which hashes the mesh: it must equal
    ``config_digest(mesh_cfg)``. ``differs`` lists the first differing
    record's sequence number and its keys that differ."""
    from repro_torch.core.journal import decode_line
    from repro_torch.durability import config_digest

    got = [decode_line(l) for l in mesh_journal.splitlines()]
    want = [decode_line(l) for l in gold_journal.splitlines()]
    digest = config_digest(mesh_cfg)
    differs = []
    if not got or got[0]["k"] != "genesis" or \
            got[0]["p"]["config"] != digest:
        differs.append("genesis digest")
    else:
        got[0] = {**got[0], "p": {**got[0]["p"],
                                  "config": want[0]["p"]["config"]}}
    if len(got) != len(want):
        differs.append(f"{len(got)} records, {len(want)} at 1x1")
    for g, w in zip(got, want):
        if g != w:
            differs.append({"q": w["q"], "keys": sorted(
                k for k in set(g) | set(w) if g.get(k) != w.get(k))})
            break
    return {"records": len(got), "genesis_digest": digest,
            "differs": differs}


def durability_phase(data, dev, model=None, mesh=None, **size) -> dict:
    """Durable runs at the paper's MNIST width (``paper_cfg``; MnistCNN
    unless ``model`` is given, ``size`` cuts the config for a rehearsal),
    under ``torch.use_deterministic_algorithms(True)`` (restored after), in
    a temporary directory removed at the end:

      1. ``apodotiko``, 3 rounds, ``durability="journal"``, a snapshot every
         round: the golden run, then two runs killed (``crash_after``)
         at the boundaries of ``crash_points`` and resumed
         (``resume_durable``) on the card: journal bytes, history, clock,
         params, free list, live rows and generator equal the golden
         run's, and the resumed runs launch ``staleness_agg`` once a
         re-executed round and ``fused_adam`` once a local step of each
         re-executed cohort's largest budget;
      2. ``apodotiko-topk``, 2 rounds, one crash mid-round 2: also the
         fleet's booster and score state, and ``block_topk`` once a
         re-executed round;
      3. the overhead: the same 3-round ``apodotiko`` run with durability
         off just before the golden run (journal, "round" sync): both
         walls, the journal's records, bytes and fsyncs, snapshot ms and
         bytes, resume ms, the overhead beside the reference's CI limit
         (informational); and a real SIGKILL of
         ``scripts/torch_durable_crash_child.py`` on the card, started
         after the golden run (so it perturbs no wall of the overhead)
         and run beside the crash runs, resumed here;
      4. ``checkpoint_resume``;
      5. with ``mesh`` (``mesh_phase``'s record), its durable golden
         run's journal against 1.'s golden journal (``mesh_journal_check``),
         and its snapshot ms and bytes, resume ms and wall beside 1.'s.

    Any difference fails the phase."""
    import shutil
    import tempfile

    from repro_torch.models.paper_models import MnistCNN

    model = model or MnistCNN()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durability_")
    t_phase = time.perf_counter()
    started = []
    try:
        off_eng, m_off, wall_off = timed_durable_run(
            paper_cfg("apodotiko", DUR_ROUNDS, **size), model, data, dev)
        del off_eng
        apo, apo_journal = golden_crash_series(
            "apodotiko", DUR_ROUNDS, crash_points, model, data, dev, tmp,
            after_golden=lambda: started.append(start_child(dev, tmp)),
            **size)
        topk, _ = golden_crash_series(
            "apodotiko-topk", DUR_TOPK_ROUNDS,
            lambda recs: {"mid_round_2": crash_points(recs)["mid_round_2"]},
            model, data, dev, tmp, **size)
        child = sigkill_child(started[0], dev, tmp)
        ckpt, _ = checkpoint_resume(model, data, dev, tmp, **size)
    finally:
        for proc, _, _ in started:      # stop the child on any failure
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(tmp, ignore_errors=True)
    overhead = apo["wall_s"] / wall_off - 1
    record = {"deterministic_algorithms": True,
              "config": {k: getattr(paper_cfg("apodotiko", DUR_ROUNDS,
                                              **size), k)
                         for k in ("n_clients", "clients_per_round",
                                   "local_epochs", "batch_size",
                                   "concurrency_ratio")},
              "apodotiko": apo, "apodotiko_topk": topk,
              "overhead": {"off_wall_s": wall_off,
                           "journal_wall_s": apo["wall_s"],
                           "overhead": overhead,
                           "reference_ci_limit": DUR_CI_LIMIT,
                           "durability_off": m_off["durability"]},
              "sigkill": child, "checkpoint": ckpt,
              "seconds": time.perf_counter() - t_phase}
    if mesh is not None:
        record["mesh_journal"] = mesh_journal_check(
            mesh["durable_journal"], apo_journal, durable_cfg(
                MESH_DUR_STRATEGY, DUR_ROUNDS, "", mesh=mesh["mesh"],
                **size))
        dur = mesh["durable"]
        record["mesh_vs_1x1"] = {
            "mesh": mesh["mesh"],
            "snapshot_ms": {"1x1": apo["snapshot_ms"], mesh["mesh"]: [
                r["snapshot_ms"] for r in dur["per_rank"]]},
            "snapshot_bytes": {"1x1": apo["snapshot_bytes"],
                               mesh["mesh"]: dur["snapshot_bytes"]},
            "snapshot_mesh_host_bytes": dur["snapshot_mesh_host_bytes"],
            "checkpoint_mesh_host_bytes": [
                r["checkpoint"]["save_mesh_host_bytes"]
                for r in dur["per_rank"]],
            "resume_ms": {"1x1": apo["crashes"][MESH_DUR_CRASH]["resume_ms"],
                          mesh["mesh"]: [r["crash"]["resume_ms"]
                                         for r in dur["per_rank"]]},
            "golden_wall_s": {"1x1": apo["wall_s"], mesh["mesh"]: [
                r["golden_wall_s"] for r in dur["per_rank"]]},
            "mesh_durable_wall_s": [r["wall_s"] for r in dur["per_rank"]]}
    emit("durability", **record)
    if mesh is not None and record["mesh_journal"]["differs"]:
        raise AssertionError(f"durability: the {mesh['mesh']} journal "
                             f"differs from the 1x1 golden journal: "
                             f"{record['mesh_journal']}")
    for name, series in (("apodotiko", apo), ("apodotiko-topk", topk)):
        for point, c in series["crashes"].items():
            if c["differs"]:
                raise AssertionError(f"durability {name} {point}: the "
                                     f"resumed run differs in {c['differs']}")
            if c["launches"] != c["launches_wanted"]:
                raise AssertionError(
                    f"durability {name} {point}: launched {c['launches']}, "
                    f"want {c['launches_wanted']}")
    if child["differs"] or child["records_on_disk"] != DUR_CHILD_CRASH:
        raise AssertionError(f"durability: the SIGKILL child's resume "
                             f"differs in {child['differs']} "
                             f"({child['records_on_disk']} records on disk)")
    check_checkpoint(ckpt, "durability")
    if m_off["durability"] != "off":
        raise AssertionError("durability: the off run journaled")
    return record


# ----------------------------------------------------------------- compress
COMPRESS_ROUNDS = 3
COMPRESS_RTOL, COMPRESS_ATOL = 1e-6, 1e-7


def mnist_update(engine, dev) -> dict:
    """The run's update: its final global MnistCNN params minus the initial
    ones (the engine's seeded init, made again)."""
    from repro_torch.models.paper_models import MnistCNN
    init = MnistCNN().init(torch.Generator().manual_seed(SEED))
    return {k: v - init[k].to(dev, torch.float32)
            for k, v in engine.params.items()}


COMPRESS_LAUNCHES = {"compress_q8": COMPRESS_ROUNDS, "quantize_q8": 0,
                     "dequantize_q8": 1}


def compress_phase(update: dict, run: str) -> dict:
    """Three ``compress_update`` calls with the error feedback carried,
    then ``decompress_update``: on the card (counts zeroed just before, read
    just after), then on a CPU copy. Each card round's codes, scales and
    error must equal the plain version ``ref.compress_q8`` run on the card
    on the same inputs to the bit; codes and scales must equal the CPU
    copy's to the bit, the error and the decompressed update be allclose
    to it; the launches exactly one fused ``compress_q8`` a compress and one
    ``dequantize_q8`` for the decompress (``COMPRESS_LAUNCHES``). Returns
    the phase record."""
    from repro_torch.kernels import ops, ref

    def rounds(upd):
        err, out = None, []
        for _ in range(COMPRESS_ROUNDS):
            (q, s, spec), err = ops.compress_update(upd, err)
            out.append((q, s, err))
        return out, ops.decompress_update(q, s, spec), spec

    zero_counts()
    t0 = time.perf_counter()
    card, card_back, spec = rounds(update)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts()
    cpu, cpu_back, _ = rounds({k: v.cpu() for k, v in update.items()})
    if read_counts() != launches:
        raise AssertionError("the CPU copy launched a kernel")
    n, n_pad = spec.n_params, card[0][0].shape[0]
    flat, ef = spec.ravel(update), None
    for r, (q, s, err) in enumerate(card):
        want = ref.compress_q8(flat, ef, n_pad)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   if a.dtype == torch.float32 else torch.equal(a, b)
                   for a, b in zip((q, s, err), want)):
            raise AssertionError(f"round {r}: compress differs from its "
                                 "plain version on the card")
        ef = err
    per_round = []
    for r, ((q, s, err), (q_c, s_c, err_c)) in enumerate(zip(card, cpu)):
        if not torch.equal(q.cpu(), q_c):
            raise AssertionError(f"round {r}: int8 codes differ card vs CPU")
        if not torch.equal(s.cpu().view(torch.int32), s_c.view(torch.int32)):
            raise AssertionError(f"round {r}: scales differ card vs CPU")
        torch.testing.assert_close(err.cpu(), err_c, rtol=COMPRESS_RTOL,
                                   atol=COMPRESS_ATOL)
        # quantization error within half a step of each block's scale
        step = s.repeat_interleave(256)[:n]
        per_round.append({
            "err_max_abs": float(err.abs().max()),
            "err_over_half_scale": float((err.abs() / (0.5 * step)).max()),
            "err_diff_vs_cpu": float((err.cpu() - err_c).abs().max())})
        if per_round[-1]["err_over_half_scale"] > 1.0 + 1e-5:
            raise AssertionError(f"round {r}: error above half a scale step")
    back_diff = 0.0
    for name, leaf in card_back.items():
        if tuple(leaf.shape) != tuple(update[name].shape) or \
                not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: decompressed leaf malformed")
        torch.testing.assert_close(leaf.cpu(), cpu_back[name],
                                   rtol=COMPRESS_RTOL, atol=COMPRESS_ATOL)
        back_diff = max(back_diff,
                        float((leaf.cpu() - cpu_back[name]).abs().max()))
    got = {k: launches[k] for k in COMPRESS_LAUNCHES}
    record = {"update_of": run, "n_params": n, "codes": n_pad,
              "scales": card[0][1].shape[0], "rounds": COMPRESS_ROUNDS,
              "launches": got, "card_s": card_s,
              "equal_to_plain_on_card": True,
              "codes_and_scales_equal": True, "per_round": per_round,
              "decompressed_diff_vs_cpu": back_diff,
              "update_max_abs": float(flat.abs().max()),
              "rtol": COMPRESS_RTOL, "atol": COMPRESS_ATOL}
    emit("compress", **record)
    if got != COMPRESS_LAUNCHES or any(
            launches[k] for k in launches if k not in COMPRESS_LAUNCHES):
        raise AssertionError(f"compress launches {launches}, want "
                             f"{COMPRESS_LAUNCHES}")
    if n_pad % 2048 or n_pad - n >= 2048:
        raise AssertionError(f"{n} params padded to {n_pad} codes")
    return record


# ---------------------------------------------------------------- attention
ATTN_HEADS, ATTN_DIM = 16, 128        # qwen3-1.7b: 16 query heads of 128
ATTN_SHORT, ATTN_LONG = 4096, 32768   # train_4k and prefill_32k lengths
ATTN_ROWS = 128                       # query rows per block of the check
ATTN_CHUNK = 1024                     # rows per plain computation, long run
ATTN_PAD_SEQ, ATTN_PAD_DIM = 1024, 96  # a head dim the kernels run padded
# Kernel vs plain, one block of ATTN_ROWS query rows at a time:
# |got - want| <= tol * (rms(want over the block) + |want|). A causal row's
# output shrinks as 1/sqrt(its prefix), so a fixed atol would be as wide as
# the values of a long run's later rows; scaled by the block's rms it stays
# a fraction of what it compares. Both sides sum in fp32, so a bf16 output
# is off by at most one bf16 ulp, 2^-7 of the value (fp16: 2^-10, held to
# the same 1e-2).
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 2e-4}


def attention_inputs(dev, seq: int, heads: int = ATTN_HEADS,
                     dim: int = ATTN_DIM) -> tuple:
    """Seeded q, k, v [1, heads, seq, dim] in fp32 on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return tuple(torch.randn(1, heads, seq, dim, device=dev, generator=gen)
                 for _ in range(3))


def plain_rows(q, k, v, start: int, rows: int) -> torch.Tensor:
    """Query rows ``[start, start + rows)`` of causal attention over the
    keys they see, computed plainly (the formulas of
    ``ref.flash_attention`` with the mask shifted to those rows)."""
    from repro_torch.kernels.ref import NEG_INF
    end = start + rows
    s = torch.einsum("bhsd,bhtd->bhst", q[:, :, start:end].float(),
                     k[:, :, :end].float()) * q.shape[-1] ** -0.5
    pos = torch.arange(start, end, device=q.device)[:, None]
    s = torch.where(pos >= torch.arange(end, device=q.device)[None], s,
                    NEG_INF)
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1),
                        v[:, :, :end].float()).to(q.dtype)


def attention_check(name: str, got, want, row0: int = 0) -> dict:
    """``got`` against ``want`` block by block of ATTN_ROWS rows, at
    ATTN_TOL scaled by each block's rms (see above); raises where a value
    is outside. ``tol_ratio`` <= 1 passes."""
    tol = ATTN_TOL[want.dtype]
    got, want = got.float(), want.float()
    max_abs, ratio, worst = 0.0, 0.0, row0
    for r in range(0, want.shape[2], ATTN_ROWS):
        w, g = want[:, :, r:r + ATTN_ROWS], got[:, :, r:r + ATTN_ROWS]
        diff = (g - w).abs()
        r_ratio = float((diff / (tol * (w.pow(2).mean().sqrt() + w.abs())))
                        .max())
        max_abs = max(max_abs, float(diff.max()))
        if r_ratio > ratio:
            ratio, worst = r_ratio, row0 + r
    if ratio > 1.0:
        raise AssertionError(f"{name}: rows {worst}..{worst + ATTN_ROWS - 1}"
                             f" off the plain version by {ratio} x the "
                             "tolerance")
    return {"max_abs_err": max_abs,
            "max_rel_err": max_abs / float(want.abs().max()),
            "want_max_abs": float(want.abs().max()), "tol_ratio": ratio,
            "worst_rows_from": worst, "rows": want.shape[2], "tol": tol}


def long_rows_check(out, q, k, v) -> dict:
    """Every query row of a causal run against ``plain_rows``, ATTN_CHUNK
    rows at a time: the plain version of a run whose whole score matrix
    would not fit."""
    parts = [attention_check(f"flash_attention long, rows {r}+",
                             out[:, :, r:r + ATTN_CHUNK],
                             plain_rows(q, k, v, r, ATTN_CHUNK), row0=r)
             for r in range(0, q.shape[2], ATTN_CHUNK)]
    worst = max(parts, key=lambda c: c["tol_ratio"])
    max_abs = max(c["max_abs_err"] for c in parts)
    want_max = max(c["want_max_abs"] for c in parts)
    return {"max_abs_err": max_abs, "max_rel_err": max_abs / want_max,
            "want_max_abs": want_max, "tol_ratio": worst["tol_ratio"],
            "worst_rows_from": worst["worst_rows_from"],
            "rows": sum(c["rows"] for c in parts), "tol": worst["tol"]}


def attention_phase(dev) -> tuple[dict, dict]:
    """Causal ``ops.flash_attention`` at ``[1, 16, 4096, 128]`` in bf16,
    fp32 and fp16 against the plain version; at ``[1, 16, 1024, 96]`` in
    bf16 and fp32 (a head dim the kernels run padded to 128); and at
    ``[1, 16, 32768, 128]`` in bf16: the first 4,096 rows equal the short
    run to the bit (a causal row sees only its prefix; the inputs are the
    long ones' prefix), and every row matches a plain computation of
    ATTN_CHUNK rows at a time. Counts are zeroed before the first call and
    before the long one, and read around every call: each is one launch.
    Returns (record, inputs)."""
    from repro_torch.kernels import ops, ref

    short, long = ATTN_SHORT, ATTN_LONG
    full32 = attention_inputs(dev, long)
    long_bf = tuple(t.to(torch.bfloat16) for t in full32)
    short_in = {"bf16": tuple(t[:, :, :short].contiguous() for t in long_bf),
                "fp32": tuple(t[:, :, :short].contiguous() for t in full32),
                "fp16": tuple(t[:, :, :short].to(torch.float16)
                              for t in full32)}
    del full32
    padded_in = {name: tuple(t.to(dtype) for t in attention_inputs(
                     dev, ATTN_PAD_SEQ, dim=ATTN_PAD_DIM))
                 for name, dtype in (("bf16", torch.bfloat16),
                                     ("fp32", torch.float32))}
    runs = {**short_in, **{f"d{ATTN_PAD_DIM}_{n}": qkv
                           for n, qkv in padded_in.items()}}
    zero_counts()
    outs, launches = {}, {}
    for name, qkv in runs.items():
        before = read_counts()["flash_attention"]
        outs[name] = ops.flash_attention(*qkv)
        torch.cuda.synchronize()
        launches[name] = read_counts()["flash_attention"] - before
    n_short = read_counts()["flash_attention"]
    zero_counts()
    t0 = time.perf_counter()
    outs["long"] = ops.flash_attention(*long_bf)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    n_long = read_counts()["flash_attention"]
    runs["long"] = long_bf
    for name, out in outs.items():
        if out.shape != runs[name][0].shape \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attention {name}: malformed output")
    out_long = outs.pop("long")
    t0 = time.perf_counter()
    long_rows = long_rows_check(out_long, *long_bf)
    check_s = time.perf_counter() - t0
    record = {
        "shape_short": list(short_in["bf16"][0].shape),
        "shape_long": list(long_bf[0].shape), "causal": True,
        "launches_short": n_short, "launches_long": n_long,
        **{f"launches_short_{n}": launches[n] for n in short_in},
        **{f"short_{n}": attention_check(f"flash_attention {n}", outs[n],
                                         ref.flash_attention(*qkv))
           for n, qkv in short_in.items()},
        "shape_padded": list(padded_in["bf16"][0].shape),
        "padded": {n: dict(attention_check(
                       f"flash_attention d{ATTN_PAD_DIM} {n}",
                       outs[f"d{ATTN_PAD_DIM}_{n}"],
                       ref.flash_attention(*qkv)),
                       launches=launches[f"d{ATTN_PAD_DIM}_{n}"])
                   for n, qkv in padded_in.items()},
        "long_prefix_rows_equal": bool(torch.equal(out_long[:, :, :short],
                                                   outs["bf16"])),
        "long_rows": long_rows, "long_check_s": check_s,
        "long_first_call_s": long_s,
        "long_plain": (f"ref.flash_attention not run whole: its fp32 score "
                       f"matrix would take {ATTN_HEADS * long**2 * 4 / 2**30:.0f}"
                       f" GiB; every row checked against plain_rows, "
                       f"{ATTN_CHUNK} rows at a time"),
        "tolerance": ("|got - want| <= tol * (rms of want over each block of "
                      f"{ATTN_ROWS} rows + |want|)"),
        "tol": {"bf16": ATTN_TOL[torch.bfloat16],
                "fp16": ATTN_TOL[torch.float16],
                "fp32": ATTN_TOL[torch.float32]}}
    emit("attention", **record)
    if not record["long_prefix_rows_equal"]:
        raise AssertionError("the long run's first rows differ from the "
                             "short run")
    if set(launches.values()) != {1} or (n_short, n_long) != (len(outs), 1):
        raise AssertionError(f"flash_attention launched {launches} and "
                             f"{n_long} times, want 1 a call")
    return record, {**{f"short_{n}": qkv for n, qkv in short_in.items()},
                    "long": long_bf}


# ------------------------------------------------------------------ kernels
def check(name: str, got, want, rtol: float = KERNEL_RTOL,
          atol: float = KERNEL_ATOL) -> dict:
    """Kernel output vs plain output: the max abs error, the max abs error
    over the largest magnitude, and the allclose criterion as a ratio
    (``tol_ratio`` <= 1 passes)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    tol_ratio = float((diff / (atol + rtol * want.abs())).max())
    if tol_ratio > 1.0:
        raise AssertionError(f"{name}: kernel vs plain max abs {max_abs}, "
                             f"{tol_ratio} x the tolerance")
    return {"max_abs_err": max_abs,
            "max_rel_err": max_abs / float(want.abs().max()),
            "tol_ratio": tol_ratio}


def main_run(record: dict) -> str:
    """Names the run whose launch counts an entry reports: a main-path run,
    or a paper_models run (its record names its model)."""
    where = (f"{record.get('phase', 'paper_models')} phase: "
             f"{record['model']}" if "model" in record else "main path")
    return f"{where}: {record['strategy']}, {len(record['rounds'])} rounds"


def agg_kernel_entry(name: str, record: dict, dev, rows_form: bool) -> dict:
    """``staleness_agg`` at the shapes of the main path's last aggregate:
    the sweep form (weights scattered over the whole [C, W] buffer) or the
    rows form (only the K referenced rows). Timed warm, calls back to
    back with the L2 holding what the last one left (``ms``, and the
    kernel's own ``device_ms``), and with the L2 flushed before each call
    (``flushed_ms``, ``flushed_device_ms``), as the main path finds it
    once a round; ``bound_share`` is the bound over the flushed device
    time. ``shape`` has the kernel's column split on this card."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import SUBLANE
    from repro_torch.kernels.staleness_agg import plan, staleness_agg

    last = record["rounds"][-1]
    C, W = last["store_capacity"], record["row_width"]
    k = last["n_aggregated"]
    kp = k + (-k) % SUBLANE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    buf = torch.randn(C, W, device=dev, generator=gen) * 0.05
    rows = torch.randperm(C, device=dev, generator=gen)[:k]
    w = torch.rand(k, device=dev, generator=gen)
    w = w / w.sum()
    if rows_form:   # zero-weight repeats of row 0 pad K, as ops._pad_rows
        rows = torch.cat([rows, rows[:1].repeat(kp - k)])
        w = torch.cat([w, torch.zeros(kp - k, device=dev)])
        args = (buf, w, rows)
        nbytes = (k * W + W) * 4 + kp * (4 + 8)
        flops = 2 * k * W
        # one bag of the referenced rows, weighted and summed
        library = lambda: torch.nn.functional.embedding_bag(
            rows[None], buf, mode="sum", per_sample_weights=w[None])[0]
    else:
        full_w = torch.zeros(C, device=dev).index_add_(0, rows, w)
        args = (buf, full_w, None)
        nbytes = (C * W + C + W) * 4
        flops = 2 * C * W
        library = lambda: full_w @ buf
    got = staleness_agg(*args)
    torch.cuda.synchronize()
    split = plan(W, torch.cuda.get_device_properties(dev).multi_processor_count)
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/staleness_agg.cu",
             "replaces": "src/repro/kernels/staleness_agg.py:38",
             "launches": record["launches"]["staleness_agg"],
             "launches_run": main_run(record),
             "shape": {"C": C, "W": W, "K": k, "K_padded": kp,
                       "rows_form": rows_form, "ctas": len(split),
                       "pieces_per_cta": max(map(len, split)),
                       "piece_bytes_max": 4 * max(b - a for p in split
                                                  for a, b in p)},
             **check(name, got, ref.staleness_agg(*args))}
    again = staleness_agg(*args)
    torch.cuda.synchronize()
    if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"{name}: two calls differ")
    entry["library_max_abs_diff"] = float((library() - got).abs().max())
    call = lambda: staleness_agg(*args)
    flush = l2_flush(dev)
    entry["ms"] = time_ms(call)
    entry["flushed_ms"] = time_ms(call, before=flush)
    # one profiler session each: the two share the kernel's name
    warm, flushed = (device_ms({"staleness_agg": fn})["staleness_agg"]
                     for fn in (call, lambda: (flush(), call())))
    put_device_ms(entry, "device_ms", warm)
    put_device_ms(entry, "flushed_device_ms", flushed)
    entry["plain_ms"] = time_ms(lambda: ref.staleness_agg(*args))
    entry["library_ms"] = time_ms(library)
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops)
    entry["bound_share"] = entry["bound_ms"] / flushed if flushed else None
    entry["bytes"] = nbytes
    return entry


def pytree_agg_entry(run: dict, dev) -> dict:
    """``staleness_agg`` as the blob update plane launches it
    (``ops.aggregate_pytree`` over K parameter trees): K MnistCNN-shaped
    trees on the card, K the plane run's last pending count, raveled and
    stacked to ``[K, N]`` and padded to ``[Kp, N4]`` (K to ``SUBLANE``
    rows of weight 0, N to the kernel's vector width), then one launch.
    The stack is the wrapper's, not the kernel's: ``stack_ms`` times it
    apart. Times as ``agg_kernel_entry``'s; the bound counts the K trees
    read, the weights and the [N] result, not the zero padding."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ops import SUBLANE, RavelSpec
    from repro_torch.kernels.staleness_agg import VEC, staleness_agg
    from repro_torch.models.paper_models import MnistCNN

    k = run["rounds"][-1]["n_aggregated"]
    template = MnistCNN().init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    trees = [{name: torch.randn(p.shape, device=dev, generator=gen) * 0.05
              for name, p in template.items()} for _ in range(k)]
    w = torch.rand(k, device=dev, generator=gen)
    w = w / w.sum()
    spec = RavelSpec(trees[0])
    n = spec.n_params
    kp, n4 = k + (-k) % SUBLANE, n + (-n) % VEC

    def stack():
        flat = torch.stack([spec.ravel(t) for t in trees], 0)
        return torch.nn.functional.pad(flat, (0, n4 - n, 0, kp - k))

    stacked = stack()
    wp = torch.nn.functional.pad(w, (0, kp - k))
    got = staleness_agg(stacked, wp)
    whole = ops.aggregate_pytree(trees, w, restore_dtype=False)
    torch.cuda.synchronize()
    entry = {"name": "staleness_agg[pytree]", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/staleness_agg.cu",
             "replaces": "src/repro/kernels/staleness_agg.py:38",
             "launches": run["launches"]["staleness_agg"],
             "launches_run": ("profiles phase: update_plane=blob, "
                              f"data_plane=host, {len(run['rounds'])} rounds"),
             "shape": {"K": k, "K_padded": kp, "N": n, "N_padded": n4},
             **check("staleness_agg[pytree]", got,
                     ref.staleness_agg(stacked, wp))}
    flat = spec.ravel(whole)
    entry["aggregate_pytree_max_abs_err"] = check(
        "aggregate_pytree", flat, got[:n])["max_abs_err"]
    call = lambda: staleness_agg(stacked, wp)
    flush = l2_flush(dev)
    entry["stack_ms"] = time_ms(stack)
    entry["ms"] = time_ms(call)
    entry["flushed_ms"] = time_ms(call, before=flush)
    warm, flushed = (device_ms({"staleness_agg": fn})["staleness_agg"]
                     for fn in (call, lambda: (flush(), call())))
    put_device_ms(entry, "device_ms", warm)
    put_device_ms(entry, "flushed_device_ms", flushed)
    entry["plain_ms"] = time_ms(lambda: ref.staleness_agg(stacked, wp))
    entry["library_ms"] = time_ms(lambda: wp @ stacked)
    entry["library_max_abs_diff"] = float((wp @ stacked - got).abs().max())
    nbytes = (k * n + k + n) * 4
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, 2 * k * n)
    entry["bound_share"] = entry["bound_ms"] / flushed if flushed else None
    entry["bytes"] = nbytes
    return entry


def adam_entry(name: str, kp: int, k: int, W: int, launches: int,
               run: str, dev) -> dict:
    """``fused_adam`` at [kp, W], the first k lanes active: event time, the
    kernel's own profiler time, the plain version's and
    ``torch._fused_adam_``'s over the active lanes. The check holds the
    kernel's output against the plain version on the same inputs,
    ``LM_CHECK_CHUNK`` columns at a time (an elementwise step: each column
    is the whole function), so a width of 1.72 B needs no more than the
    inputs and the kernel's copies of p, m, v; the plain version is timed
    once those copies are gone, ``ADAM_PLAIN_PIECE`` columns at a time,
    the pieces' times summed (one piece below that width)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam

    lr, b1, b2, eps, s = 1e-3, 0.9, 0.999, 1e-8, 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = torch.randn(kp, W, device=dev, generator=gen) * 0.05
    g = torch.randn(kp, W, device=dev, generator=gen) * 0.01
    m = torch.randn(kp, W, device=dev, generator=gen) * 1e-3
    v = torch.rand(kp, W, device=dev, generator=gen) * 1e-5
    steps = torch.zeros(kp, dtype=torch.int32, device=dev)
    steps[:k] = 150
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps)

    mine = [t.clone() for t in (p, m, v)]
    fused_adam(*mine, g, steps, s, **hyper)
    torch.cuda.synchronize()
    errs = []
    for a in range(0, W, LM_CHECK_CHUNK):
        cols = slice(a, min(a + LM_CHECK_CHUNK, W))
        plain = [t[:, cols].clone() for t in (p, m, v)]
        ref.fused_adam(*plain, g[:, cols], steps, s, **hyper)
        errs += [check(name, x[:, cols], y) for x, y in zip(mine, plain)]
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused_adam.cu",
             "replaces": "src/repro/kernels/fused_adam.py:52",
             "launches": launches, "launches_run": run,
             "shape": {"Kp": kp, "W": W, "active_lanes": k},
             **{key: max(e[key] for e in errs) for key in errs[0]}}
    call = lambda: fused_adam(*mine, g, steps, s, **hyper)
    entry["ms"] = time_ms(call)
    put_device_ms(entry, "device_ms",
                  device_ms({"fused_adam": call})["fused_adam"])
    del mine, call
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pieces = [slice(a, min(a + ADAM_PLAIN_PIECE, W))
              for a in range(0, W, ADAM_PLAIN_PIECE)]
    entry["plain_ms"] = sum(time_ms(
        lambda c=c: ref.fused_adam(p[:, c], m[:, c], v[:, c], g[:, c], steps,
                                   s, **hyper)) for c in pieces)
    entry["plain_pieces"] = len(pieces)

    # yardstick: PyTorch's own fused Adam over the active lanes' rows, in
    # pieces of at most 2^30 elements
    piece = 1 << 30
    lib = [[t[i, a:a + piece] for i in range(k) for a in range(0, W, piece)]
           for t in (p, m, v, g)]
    step_t = [torch.tensor(float(s + 1), device=dev) for _ in lib[0]]

    def library():
        torch._fused_adam_(lib[0], lib[3], lib[1], lib[2], [], step_t, lr=lr,
                           beta1=b1, beta2=b2, weight_decay=0.0, eps=eps,
                           amsgrad=False, maximize=False)

    entry["library_ms"] = time_ms(library)
    nbytes = k * W * 7 * 4 + kp * 4      # read p m v g, write p m v
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, k * W * 14)
    entry["bytes"] = nbytes
    return entry


def adam_kernel_entry(record: dict, dev, name: str = "fused_adam") -> dict:
    """``fused_adam`` at the run's largest cohort: Kp lanes (the cohort
    padded to a power of two) of its row width, the pad lanes inactive."""
    from repro_torch.core.client import DEFAULT_COHORT_FLOOR, _bucket

    k = max(record["cohort_sizes"])
    return adam_entry(name, _bucket(k, DEFAULT_COHORT_FLOOR), k,
                      record["row_width"], record["launches"]["fused_adam"],
                      main_run(record), dev)


def lm_kernel_entries(rec: dict, dev) -> list:
    """The LM phase's kernels at its shapes: ``fused_adam[qwen3-1.7b]``,
    the centralized step's one lane of every param (padded to the kernel's
    vector width), ``fused_adam[fl_lm]`` at the federated run's largest
    cohort, and ``staleness_agg[fl_lm]`` at its last aggregate, in the
    route the run took, and in the rows form beside it."""
    from repro_torch.kernels.fused_adam import VEC

    train, fl = rec["train"], rec["fl"]
    reset_peak(dev)
    n = train["n_params"]
    run = (f"lm phase: {train['arch']} launch.train, {train['steps']} "
           "steps")
    entries = [adam_entry(f"fused_adam[{train['arch']}]", 1, 1,
                          n + (-n) % VEC, train["launches"]["fused_adam"],
                          run, dev)]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    entries.append(adam_kernel_entry(fl, dev, name="fused_adam[fl_lm]"))
    rows_form = fl["agg_route"] == "gather"
    entries.append(agg_kernel_entry("staleness_agg[fl_lm]", fl, dev,
                                    rows_form=rows_form))
    if not rows_form:
        entries.append(agg_kernel_entry("staleness_agg[fl_lm,rows]", fl, dev,
                                        rows_form=True))
    return entries


def paper_kernel_entries(records: dict, dev) -> list:
    """The main-path kernels at each paper_models run's own shapes:
    ``fused_adam[<model>]`` for the Adam models, and
    ``staleness_agg[<model>]`` in rows form at every run's last K (the
    column split follows the row width)."""
    entries = []
    for name, record in records.items():
        if PAPER_RUNS[name]["optimizer"] == "adam":
            entries.append(adam_kernel_entry(record, dev,
                                             name=f"fused_adam[{name}]"))
        entries.append(agg_kernel_entry(f"staleness_agg[{name}]", record,
                                        dev, rows_form=True))
        torch.cuda.empty_cache()
    return entries


def topk_scores(m: int, dev) -> torch.Tensor:
    """Scores shaped like the selection's: about half -inf (busy or
    unregistered slots), a few +inf (never invoked), and planted ties
    across blocks."""
    gen = torch.Generator(device=dev).manual_seed(SEED + m)
    s = torch.rand(m, device=dev, generator=gen) * 50.0
    s[torch.rand(m, device=dev, generator=gen) < 0.5] = float("-inf")
    s[torch.randperm(m, device=dev, generator=gen)[:8]] = float("inf")
    tie = float(s[torch.isfinite(s)].max())
    s[torch.randperm(m, device=dev, generator=gen)[:64]] = tie
    return s


def max_abs_finite(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference over the entries where ``want`` is finite (equal
    infinities and NaNs were already checked bit for bit)."""
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()) if finite.any() \
        else 0.0


def topk_kernel_entry(name: str, m: int, k: int, launches: int,
                      launches_run: str, dev) -> dict:
    """The selection's top-k (``ops.masked_topk``, one launch) and the
    per-block candidates (``block_topk``) at ``[m]``, against their plain
    versions (stable descending sorts) exactly: values to the bit and
    indices. ``torch.topk`` computes the same values and is the library
    yardstick; how many of its indices differ is recorded (its tie order
    is not ``lax.top_k``'s). ``launches`` were counted in the run that
    ``launches_run`` names. The bound is the function's: read the scores
    once and write the top k, with about one comparison per score."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.topk import BLOCK_TOPK, block_topk

    s = topk_scores(m, dev)
    cand_v, cand_i = block_topk(s, k)
    before = block_topk.launches
    vals, idx = ops.masked_topk(s, k)
    torch.cuda.synchronize()
    calls = block_topk.launches - before      # 1 on the card, 0 on the CPU
    want_cv, want_ci = ref.block_topk(s, k, BLOCK_TOPK)
    want_v, want_i = ref.masked_topk(s, k)
    if not (torch.equal(cand_i, want_ci) and torch.equal(idx, want_i)):
        raise AssertionError(f"{name}: indices differ from the plain version")
    if not (torch.equal(cand_v.view(torch.int32), want_cv.view(torch.int32))
            and torch.equal(vals.view(torch.int32),
                            want_v.view(torch.int32))):
        raise AssertionError(f"{name}: values differ from the plain version")
    if calls != (1 if s.is_cuda else 0):
        raise AssertionError(f"{name}: masked_topk took {calls} launches, "
                             "not one")
    lib_v, lib_i = torch.topk(s, k)
    if not torch.equal(lib_v, vals):
        raise AssertionError(f"{name}: torch.topk values differ")
    nbytes = m * 4 + k * (4 + 8)          # read the scores, write the top k
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topk.cu",
             "replaces": "src/repro/kernels/topk.py:61",
             "launches": launches, "launches_run": launches_run,
             "shape": {"M": m, "k": k, "passes": max(calls - 1, 0),
                       "finite": int(torch.isfinite(s).sum())},
             "max_abs_err": max_abs_finite(vals, want_v), "exact": True,
             "library_idx_differ": int((lib_i != idx).sum()),
             "timed": "ops.masked_topk on seeded scores shaped like the "
                      "selection's; the paths select through "
                      "ops.scored_topk (the scored_topk entries)"}
    entry["ms"] = time_ms(lambda: ops.masked_topk(s, k))
    put_device_ms(entry, "device_ms", device_ms(
        {"topk_select_kernel": lambda: ops.masked_topk(s, k)}
    )["topk_select_kernel"])
    entry["candidates_ms"] = time_ms(lambda: block_topk(s, k))
    entry["plain_ms"] = time_ms(lambda: ref.masked_topk(s, k))
    entry["library_ms"] = time_ms(lambda: torch.topk(s, k))
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, m)
    entry["bytes"] = nbytes
    return entry


def composed_scored_topk(num, den, booster, eligible, ever, beta, k):
    """The selection step as separate torch passes with ``torch.topk`` for
    the top-k: the yardstick of the fused kernel (no one PyTorch call
    computes the step; ``torch.topk``'s tie order is not ``lax.top_k``'s)."""
    score = booster * (num / torch.clamp_min(den, 1e-12))
    score = torch.where(ever, score, float("inf"))
    score = torch.where(eligible, score, float("-inf"))
    vals, idx = torch.topk(score, k)
    valid = vals > float("-inf")
    chosen = torch.zeros_like(eligible)
    chosen[idx] = valid
    boost = torch.where(chosen, 1.0,
                        torch.where(eligible, booster * beta, booster))
    return idx, valid, boost


def scored_topk_entry(name: str, state, k: int, beta: float, launches: int,
                      launches_run: str) -> dict:
    """The fused selection step (``ops.scored_topk``: score, masks, top-k
    and booster update in one launch) on ``state``, a ``FleetStore``'s
    device score state, at ``k`` and ``beta`` as its path calls it, held
    to the plain composition ``ref.scored_topk`` on the same tensors
    exactly: idx, valid and the new booster to the bit. The bound is the
    step's bytes: num, den, booster (fp32) and eligible, ever (bool) read
    once, the new booster written once, 18 B a slot, and the k picks and
    flags."""
    from repro_torch.kernels import ops, ref

    args = (state.num, state.den, state.booster, state.eligible, state.ever,
            beta, k)
    m = state.booster.shape[0]
    got = ops.scored_topk(*args)
    torch.cuda.synchronize()
    want = ref.scored_topk(*args)
    for what, a, b in zip(("idx", "valid", "booster"), got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs from the "
                                 "plain version")
    nbytes = 18 * m + k * (8 + 1)
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topk.cu",
             "replaces": "src/repro/kernels/topk.py:61",
             "replaces_also": "src/repro/kernels/ops.py:308 scored_topk",
             "launches": launches, "launches_run": launches_run,
             "shape": {"M": m, "k": k, "beta": beta,
                       "eligible": int(state.eligible.sum()),
                       "valid": int(got[1].sum())},
             "max_abs_err": max_abs_finite(got[2], want[2]), "exact": True,
             "library_ms": None,
             "library_note": "no single PyTorch call computes the step; "
                             "composed_ms is the stepwise torch composition "
                             "with torch.topk"}
    entry["ms"] = time_ms(lambda: ops.scored_topk(*args))
    put_device_ms(entry, "device_ms", device_ms(
        {"topk_select_kernel": lambda: ops.scored_topk(*args)}
    )["topk_select_kernel"])
    entry["plain_ms"] = time_ms(lambda: ref.scored_topk(*args))
    entry["composed_ms"] = time_ms(lambda: composed_scored_topk(*args))
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, m)
    entry["bytes"] = nbytes
    return entry


def main_path_selection(engine) -> tuple:
    """The main path's selection state after its run: the store's device
    score state with the pending dirty slots flushed, as the next
    ``select_topk`` would see it, and the k and beta it is called with."""
    from repro_torch.core.scoring import promotion_rate

    engine.db.fleet._flush_device()
    return (engine.db.fleet._dev, engine.cfg.clients_per_round,
            promotion_rate(engine.cfg.adjustment_rate))


def compress_kernel_entry(update: dict, launches: int, run: str) -> dict:
    """``compress_q8`` at the compress phase's steady state: the update
    raveled, with its first round's error feedback carried (what the
    second and third ``compress_update`` calls hand the kernel), held to
    its plain version ``ref.compress_q8`` and to the stepwise path it
    replaces to the bit (codes, scales, error). ``composed_ms`` and
    ``composed_device_ms`` time that stepwise path (add, pad,
    ``quantize_q8``, ``dequantize_q8``, slice, subtract). The bound is the
    fused call's bytes: flat and the error feedback read (4N each), the
    codes, the scales and the error written (n_pad + 4 n_pad / 256 + 4N).
    No single PyTorch call computes the step."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant8 import (QBLOCK, ROWS, compress_q8,
                                            dequantize_q8, quantize_q8)

    flat = ops.RavelSpec(update).ravel(update)
    n = flat.shape[0]
    n_pad = n + (-n) % (ROWS * QBLOCK)
    ef = compress_q8(flat, None, n_pad)[2]          # the first round's error

    def composed():
        v = flat + ef
        q, s = quantize_q8(torch.nn.functional.pad(v, (0, n_pad - n)))
        return q, s, v - dequantize_q8(q, s)[:n]

    got = compress_q8(flat, ef, n_pad)
    torch.cuda.synchronize()
    want = ref.compress_q8(flat, ef, n_pad)
    for what, other in (("plain version", want),
                        ("stepwise path", composed())):
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   if a.dtype == torch.float32 else torch.equal(a, b)
                   for a, b in zip(got, other)):
            raise AssertionError(f"compress_q8: kernel differs from the "
                                 f"{what}")
    nbytes = 3 * 4 * n + n_pad + 4 * (n_pad // QBLOCK)
    entry = {"name": "compress_q8", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/quant8.cu",
             "replaces": "src/repro/kernels/quant8.py:58",
             "replaces_also": "src/repro/kernels/quant8.py:89, both as "
                              "src/repro/kernels/ops.py:357 compress_update "
                              "composes them",
             "launches": launches, "launches_run": run,
             "shape": {"N": n, "N_padded": n_pad, "blocks": n_pad // QBLOCK,
                       "error_feedback": True},
             "max_abs_err": float((got[2] - want[2]).abs().max()),
             "exact": True, "bytes": nbytes, "library_ms": None,
             "library_note": "no single PyTorch call computes block-scaled "
                             "int8 codes with error feedback; composed_ms "
                             "is the stepwise path the kernel replaces"}
    entry["ms"] = time_ms(lambda: compress_q8(flat, ef, n_pad))
    put_device_ms(entry, "device_ms", device_ms(
        {"compress_q8_kernel": lambda: compress_q8(flat, ef, n_pad)}
    )["compress_q8_kernel"])
    entry["plain_ms"] = time_ms(lambda: ref.compress_q8(flat, ef, n_pad))
    entry["composed_ms"] = time_ms(composed)
    put_device_ms(entry, "composed_device_ms", device_total_ms(composed))
    # add, abs, max, divide, round, clip, multiply, subtract a value
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, 8 * n_pad)
    return entry


def quant8_kernel_entries(update: dict, launches: dict, run: str) -> list:
    """``quantize_q8`` and ``dequantize_q8`` at the compress phase's shape:
    the update raveled and zero-padded to a multiple of 2048, as
    ``compress_update`` hands it to the kernels. Both are held to their
    plain versions exactly (codes, scales and values to the bit).
    ``dequantize_q8``'s library call is one ``torch.mul`` of the codes as
    [blocks, 256] by the scales as [blocks, 1] (int8 x fp32 promotes to
    fp32), also held to the bit; no single PyTorch call computes
    ``quantize_q8``'s block-scaled int8 codes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant8 import QBLOCK, dequantize_q8, quantize_q8

    flat = ops.RavelSpec(update).ravel(update)
    x = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % 2048))
    n, nb = x.shape[0], x.shape[0] // QBLOCK
    q, s = quantize_q8(x)
    got = dequantize_q8(q, s)
    library = lambda: torch.mul(q.view(-1, QBLOCK), s.view(-1, 1))
    lib = library()
    torch.cuda.synchronize()
    want_q, want_s = ref.quantize_q8(x)
    want = ref.dequantize_q8(q, s)
    if not (torch.equal(q, want_q) and torch.equal(s.view(torch.int32),
                                                   want_s.view(torch.int32))):
        raise AssertionError("quantize_q8: kernel differs from the plain "
                             "version")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("dequantize_q8: kernel differs from the plain "
                             "version")
    if not (lib.dtype == torch.float32 and torch.equal(
            lib.reshape(-1).view(torch.int32), got.view(torch.int32))):
        raise AssertionError("dequantize_q8: torch.mul differs from the "
                             "kernel")
    nbytes = n * 4 + n + nb * 4          # fp32 values, int8 codes, scales
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/quant8.cu",
              "launches_run": run, "shape": {"N": n, "blocks": nb},
              "exact": True, "bytes": nbytes}
    entries = []
    # (quantize_q8 launches the fused compress kernel without error feedback)
    for name, line, kernel, fn, plain, lib_fn, flops, err in (
            ("quantize_q8", 58, "compress_q8_kernel", lambda: quantize_q8(x),
             lambda: ref.quantize_q8(x), None,
             5 * n,                              # abs, max, div, round, clip
             (s - want_s).abs().max()),
            ("dequantize_q8", 89, "dequantize_q8_kernel",
             lambda: dequantize_q8(q, s), lambda: ref.dequantize_q8(q, s),
             library, n, (got - want).abs().max())):   # one multiply
        e = {"name": name, "replaces": f"src/repro/kernels/quant8.py:{line}",
             "launches": launches[name], "max_abs_err": float(err), **common}
        if name == "quantize_q8":
            e["launches_note"] = ("compress_update runs the fused "
                                  "compress_q8; no path calls quantize_q8 "
                                  "alone, the reference's entry point")
        e["ms"] = time_ms(fn)
        e["plain_ms"] = time_ms(plain)
        calls = {kernel: fn}
        if lib_fn is None:
            e["library_ms"] = None
            e["library_note"] = ("no single PyTorch call computes "
                                 "block-scaled int8 codes")
        else:
            e["library_ms"] = time_ms(lib_fn)
            e["library"] = ("torch.mul(q.view(-1, 256), s.view(-1, 1)), "
                            "bit-equal to the kernel")
            calls["elementwise"] = lib_fn
        dev_ms = device_ms(calls)
        put_device_ms(e, "device_ms", dev_ms[kernel])
        if lib_fn is not None:
            put_device_ms(e, "library_device_ms", dev_ms["elementwise"])
        e["bound_ms"], e["bound_by"] = bound(nbytes, flops)
        entries.append(e)
    return entries


def attention_work(B: int, H: int, S: int, D: int, elt: int
                   ) -> tuple[int, int]:
    """Causal attention forward's least work: two products over the lower
    triangle (4*B*H*D*S(S+1)/2 flops) and q, k, v read and the output
    written once (4*B*H*S*D elements)."""
    return 4 * B * H * D * S * (S + 1) // 2, 4 * B * H * S * D * elt


def attention_kernel_entry(name: str, qkv: tuple, launches: int, run: str,
                           checked: dict, reps: int = 20) -> dict:
    """``flash_attention`` (causal) on ``qkv``, timed beside
    ``F.scaled_dot_product_attention(is_causal=True)``, the library call
    for the same function, and beside the plain version; ``checked`` is the
    attention phase's check of the same output against it. Where the whole
    plain version does not fit (``S`` past ATTN_SHORT), the plain time is
    of ``plain_rows`` over every row, ATTN_CHUNK rows at a time. The bound
    is the function's: causal flops 4*B*H*D*S(S+1)/2 at the 16-bit tensor
    rate for bf16 and fp16; for fp32, which the kernel computes as three
    TF32 products a product, three times those flops at the TF32 tensor
    rate (``fp32_fma_bound_ms`` keeps the flops at the 67 TFLOP/s of fp32
    FMA, the bound before this design); bytes q, k, v read and the output
    written once. ``design`` names the kernel the input type takes (bf16
    and fp16: wgmma fed by a TMA ring; fp32: three TF32 mma.sync products);
    ``tflops`` and ``device_tflops`` are the achieved rates, the function's
    flops over ``ms`` and over ``device_ms``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    from repro_torch.device import fp32_exact

    q, k, v = qkv
    B, H, S, D = q.shape
    got = flash_attention(q, k, v)
    fp32 = q.dtype == torch.float32

    def library():
        # fp32 SDPA with TF32 off: the fp32 function, as the plain version
        # and the kernel compute it
        with fp32_exact():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True)

    lib = library()
    torch.cuda.synchronize()
    entry = {"name": name, "route": "cuda",
             "design": "cuda-mma-3xtf32" if fp32 else "cuda-wgmma-tma",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:82",
             "launches": launches, "launches_run": run,
             "shape": {"B": B, "H": H, "S": S, "D": D,
                       "dtype": str(q.dtype), "causal": True},
             "library_max_abs_diff": float((lib.float() - got.float())
                                           .abs().max()),
             "library_tf32": False, **checked}
    if S <= ATTN_SHORT:
        plain = lambda: ref.flash_attention(q, k, v)
    else:
        plain = lambda: [plain_rows(q, k, v, r, ATTN_CHUNK)
                         for r in range(0, S, ATTN_CHUNK)]
        entry["plain_note"] = (
            f"plain_ms is of plain_rows over every row, {ATTN_CHUNK} rows at "
            f"a time: ref.flash_attention whole would need a "
            f"{B * H * S * S * 4 / 2**30:.0f} GiB fp32 score matrix")
    warmup = 1 if reps < 20 else 3
    entry["ms"] = time_ms(lambda: flash_attention(q, k, v), reps=reps,
                          warmup=warmup)
    put_device_ms(entry, "device_ms", device_ms(
        {"flash_fwd_kernel": lambda: flash_attention(q, k, v)},
        reps=min(reps, 10))["flash_fwd_kernel"])
    entry["plain_ms"] = time_ms(plain, reps=min(reps, 5), warmup=1)
    entry["library_ms"] = time_ms(library, reps=reps, warmup=warmup)
    flops, nbytes = attention_work(B, H, S, D, q.element_size())
    if fp32:
        entry["bound_ms"], entry["bound_by"] = bound(
            nbytes, TF32_PRODUCTS * flops, TF32_FLOP_PER_S)
        entry["fp32_fma_bound_ms"] = bound(nbytes, flops)[0]
    else:
        entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOP_PER_S)
    entry["flops"], entry["bytes"] = flops, nbytes
    entry["tflops"] = flops / entry["ms"] / 1e9 if entry["ms"] else None
    entry["device_tflops"] = (flops / entry["device_ms"] / 1e9
                              if entry["device_ms"] else None)
    return entry


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "launches_run", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


# kept in the kernel list where an entry has them: the kernel's own time
# (profiler), for the fused selection step and the fused compress step the
# stepwise composition's (for compress also its device time), for fp32
# attention the bound at the fp32 FMA rate, and for staleness_agg the event
# and device times with the L2 flushed before each call and the bound over
# the flushed device time
EXTRA_KEYS = ("device_ms", "composed_ms", "composed_device_ms",
              "fp32_fma_bound_ms", "flushed_ms", "flushed_device_ms",
              "bound_share")


def report_lines(kernels: list, kind: str, count: int) -> list:
    """The last two lines of the output: the kernel list, then the result
    line. Every line the script prints on stdout is one JSON object."""
    return [json.dumps({"kernels": [
                {k: e[k] for k in KERNEL_KEYS + EXTRA_KEYS if k in e}
                for e in kernels]}),
            json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": kind, "count": count}})]


# --------------------------------------------------------------------- main
def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        return fail("no CUDA card is available; this script runs only on one")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    for mod in ("jax", "repro"):          # the port must not need either
        sys.modules[mod] = None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    tf32 = tf32_flags()
    emit("card", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=tf32[0], matmul_allow_tf32=tf32[1],
         tf32_note=("torch's own defaults, untouched: the trainer and the "
                    "evaluation turn TF32 off in their own scope "
                    "(repro_torch.device.fp32_exact), as do the fp32 "
                    "attention library and plain calls"))

    from repro_torch.device import fp32_exact
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         build_dir=str(_build.BUILD_DIR),
         ptxas={k: [l.strip() for l in v.splitlines()
                    if any(w in l for w in ("registers", "spill", "C75"))]
                for k, v in logs.items()})

    from repro_torch.data.synthetic import make_federated_dataset
    t0 = time.perf_counter()
    data = make_federated_dataset(**MAIN_DATA)
    emit("data", seconds=time.perf_counter() - t0, X=list(data.X.shape),
         eval_n=len(data.eval_y))
    phase_s = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    apo_engine, apo = run_main_path("apodotiko", 3, data, dev)
    _, avg = run_main_path("fedavg", 1, data, dev)
    topk_engine, top = run_main_path("apodotiko-topk", 3, data, dev)
    run_main_path("scaffold", 2, data, dev)
    phase_s["main_path"] = time.perf_counter() - t0
    mesh = timed("mesh", mesh_phase, {
        "engines": {"apodotiko": apo_engine, "apodotiko-topk": topk_engine},
        "records": {"apodotiko": apo, "apodotiko-topk": top}}, dev,
        MAIN_DATA)
    # the launch phase's meta sweep needs no card: its children (one
    # thread each) run beside the phases from here on, out of the mesh
    # phase's way, and the launch phase collects them
    import tempfile
    sweep_started = start_meta_sweep(tempfile.mkdtemp(
        prefix="chip_smoke_sweep_"))
    timed("megastep", megastep_phase, data, dev)
    profiles = timed("profiles", profiles_phase, data, dev)
    timed("durability", durability_phase, data, dev, mesh=mesh)
    main_m = topk_engine.db.fleet.capacity
    main_selection = main_path_selection(topk_engine)
    fleet, fleet_state = timed("fleet", fleet_phase, dev)
    timed("topk_sort_route", topk_sort_route_phase, fleet_state, dev)
    timed("reference", reference_phase, dev)
    timed("profile", profile_round, data, dev, avg["rounds"][0]["wall_s"],
          avg["largest_step_budget"])
    update = mnist_update(apo_engine, dev)
    compress = timed("compress", compress_phase, update, main_run(apo))
    with fp32_exact():
        attention, attn_inputs = timed("attention", attention_phase, dev)
    paper = timed("paper_models", paper_models_phase, dev)
    timed("sweep", sweep_phase, dev)
    torch.cuda.empty_cache()
    lm = timed("lm", lm_phase, dev)
    # timed now, while the card holds nothing else: the 1.72 B-wide Adam
    # entry holds ~48 GB of inputs and kernel copies
    lm_entries = timed("lm_kernel_entries", lm_kernel_entries, lm, dev)
    moe = timed("moe", moe_phase, dev)
    moe_entries = timed("moe_kernel_entries", moe_kernel_entries, moe, dev)
    ssm = timed("ssm", ssm_phase, dev)
    ssm_entries = timed("ssm_kernel_entries", ssm_kernel_entries, ssm, dev)
    xattn = timed("xattn", xattn_phase, dev)
    xattn_entries = timed("xattn_kernel_entries", xattn_kernel_entries,
                          xattn, dev)
    timed("launch", launch_phase, dev, started=sweep_started)
    if tf32_flags() != tf32:
        raise AssertionError(f"TF32 flags {tf32_flags()} after the runs, "
                             f"{tf32} before: a scope leaked")

    n_topk = top["launches"]["block_topk"]
    fleet_run = f"fleet phase: {FLEET_ROUNDS} select_topk calls at M = 1e6"
    t0 = time.perf_counter()
    kernels = [agg_kernel_entry("staleness_agg", avg, dev, rows_form=False),
               agg_kernel_entry("staleness_agg[rows]", apo, dev,
                                rows_form=True),
               adam_kernel_entry(apo, dev),
               topk_kernel_entry("block_topk", main_m, 100, n_topk,
                                 main_run(top), dev),
               scored_topk_entry("scored_topk", *main_selection, n_topk,
                                 main_run(top)),
               topk_kernel_entry("block_topk[fleet]", FLEET_CAPACITY, FLEET_K,
                                 sum(fleet["launches_per_call"]), fleet_run,
                                 dev),
               scored_topk_entry("scored_topk[fleet]", fleet_state, FLEET_K,
                                 FLEET_BETA, sum(fleet["launches_per_call"]),
                                 fleet_run)]
    compress_run = (f"compress phase: {COMPRESS_ROUNDS} compress_update "
                    "calls and one decompress_update")
    kernels.append(compress_kernel_entry(
        update, compress["launches"]["compress_q8"], compress_run))
    kernels += quant8_kernel_entries(update, compress["launches"],
                                     compress_run)
    kernels += [
        attention_kernel_entry(
            "flash_attention" + ("" if n == "bf16" else f"[{n}]"),
            attn_inputs[f"short_{n}"], attention[f"launches_short_{n}"],
            f"attention phase: causal [1,16,4096,128] in {n}",
            attention[f"short_{n}"])
        for n in ("bf16", "fp32", "fp16")] + [
        attention_kernel_entry(
            "flash_attention[prefill_32k]", attn_inputs["long"],
            attention["launches_long"],
            "attention phase: causal [1,16,32768,128] in bf16",
            attention["long_rows"], reps=5)]
    torch.cuda.empty_cache()
    kernels += paper_kernel_entries(paper, dev)
    kernels.append(pytree_agg_entry(profiles["pytree_run"], dev))
    kernels += lm_entries + moe_entries + ssm_entries + xattn_entries
    kernels.append(mesh_kernel_entry(mesh, apo, dev))
    phase_s["kernel_entries"] = time.perf_counter() - t0
    for e in kernels:
        emit("kernel", **e)
    emit("total", seconds=time.perf_counter() - t_start, phases=phase_s)
    for line in report_lines(kernels, kind, torch.cuda.device_count()):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
