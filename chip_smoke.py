#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env — the card (``nvidia-smi`` name and power limit, compute capability
   9.0), ``nvcc``'s version, the build of the CUDA kernels (and the graph
   reader) from ``src/repro_torch/csrc`` and
   each kernel instance's registers and spills from the build's ptxas
   report (``k1_resources``, ``k2_resources``, ``k3_resources``);
2. kernels — ``limb_matmul`` (K1) and ``mont_fold`` (K2) against their plain
   PyTorch versions on the card, bit for bit, at every main-path shape and
   at edge cases (for K2: every n_diag from 1 to 8 with every int32 edge on
   every diagonal, m = 2, 3 and 2**31 - 1, output counts that are no
   multiple of the block size); then their times at the main-path shapes
   (CUDA events around runs of back-to-back calls, median of 50 runs, K1 in
   turns with its plain version and the library call; and the kernel's own
   device time from torch.profiler) beside the plain version, the bound,
   the grid and, for K1, one library call (its time per call and on the
   device); the launch floor (an empty kernel's device time, read the same
   way, and K2's device time over it); the pass spans (``pass_span``): for
   each K2 shape and its K1 partner, 20 passes captured as one CUDA graph
   and replayed between CUDA events (median of 50, in turns) as K1 → K2,
   K1 alone and K1 → the empty kernel, so K2's marginal cost in a pass
   beside its standalone device time, and the graph's residues equal to
   the eager pass's after every buffer was overwritten; and the launch
   path of one K1 call split into the bare ctypes launch, the ``*_cuda``
   wrapper and the full ``ops`` call, with K2's full ``ops`` call beside it;
3. engines — Dilithium at d ∈ {64, 128, 256, 512} (eager fp32 and lazy
   int32, κ = 2) and a per-plane staged transform against an int64 numpy
   oracle; BN254 (d = 64, 9 channels) against the same engine on the CPU;
4. variants — the deferred core variants, one line per part.  ``table1``:
   the Table-1 probes through K1 (``accumulator.table1_rows`` on the card,
   one (1, K) × (K, 1) K1 call per target and model, K up to 33,419)
   beside K1's plain version on the card and on the CPU, with the sum each
   returned per target; the int32 rows must be all True, the fp32 entries
   True up to 2**24 and False at 2**24 + 1 and 2**25 − 1 on every path, and
   the CPU rows equal to the JAX package's; the fp32 entries at 2**28 and
   2**30 are reported, not checked; then K1's time at the shapes of the 2**28
   and 2**30 probes beside its plain version, ``torch.matmul`` and its bound.
   ``staged_variants``: ``staged_transform_traced`` and
   ``staged_transform_scan`` for Dilithium at d = 256 and 2048 and the
   4-limb prime of Fig. 3 at d = 512, at 8 and 128 rows, fp32 eager and
   int32 lazy (κ = 2 and one window, tile 171), each equal to
   ``staged_transform`` on the same plan, to the int64 oracle and (d = 256)
   to ``matrix_transform_ref`` on the CPU, its K1/K2 launches equal to
   passes × La·Lw and the folds (the scan form's padded passes included).
   ``crossover``: Fig. 3 on the card, one row of that prime, 4 × 4 limbs,
   d = 256 … 4096: ``cooley_tukey_ntt`` equal to ``staged_transform`` (and
   to ``fused_transform``, K3, where the plan is fused, d <= 1024) and to
   the bignum oracle up to d = 1024; each form timed op by op and as one
   captured CUDA graph (in turns, median of 50), with the ratio matrix ÷
   CT, each form's launches and device kernels per call, and the matrix
   form's t(d) / t(d/2) against the 4.0 of O(d²);
5. fused — ``fused_ntt_tile`` (K3) against its plain version, bit for bit,
   at the fused path's shapes and at edge cases, which must reach both of its
   B-load variants, clusters of one and of more blocks and every n_diag from
   1 to 8; the single-tenant fused
   transform (``repro_torch.kernels.fused_transform``, one K3 launch per
   staging pass) at full width: ML-DSA d = 256 at 128 rows (both
   accumulators) and Dilithium d = 2048 against the int64 oracle, BN254
   d = 256 (9 channels) against the K1 + K2 engine path and the bignum
   oracle; then K3's times beside its bound (and, for fp32_mantissa, the
   bound with the multiply-adds priced as FFMA), its launch geometry, its
   plain version and the unfused pair K1 + K2 on the same pass, the two
   timed in turns per call and as graph spans (K2 is a programmatic
   dependent of K1, so the pair's profiler durations overlap and are not
   added), and one fused transform beside one staged transform;
6. slice — the offline multi-tenant replay (``serve_crypto``) of the paper's
   trace (λ = 4096 req/s for 0.25 s, 50:50 Dilithium:BN254, n_c = 8) and of
   the mixed eager/lazy configuration, each twice on one co-scheduler: cold
   (each of its programs, one CUDA graph of a class's whole e2e per launch
   height, captured at first use) and warm (every launch one replay,
   nothing captured).  Every tenant row is checked (Dilithium against the
   int64 oracle, BN254 against the CPU replay) and every kernel launch
   counted against the engines' fold profiles: the program runs, each
   capture's warm-up and the warm-up of each class's validation probe
   (``serve_crypto`` validates every class before its first dispatch), and
   every program's recorded K1/K2 calls (no K3 launch: the replay does not
   take the fused path).  The line gives the
   cold run's wall time and launches (``wall_s``, as a first replay on a
   fresh co-scheduler), the warm run's under ``warm``, captures, their host
   seconds and the graph pool's bytes; then two more warm runs of the paper
   trace split its wall time (``profile``: host timers around the programs'
   H2D copies, replays, D2H copies and the waits on their events;
   torch.profiler for device time, whose K1/K2 kernel events must equal the
   counted launches, and are the kernel table's K1/K2 ``launches``), and
   one BN254 and one Dilithium dispatch time their program against the
   same ``e2e`` called op by op;
7. validator — the structural validator (``repro_torch.core.validator``)
   on the card: for every class of the paper and mixed eager/lazy replays,
   the census probe of before (a plain capture) and the server's probe now
   (``validate_fn``: the capture with its graph kept, read by
   ``csrc/graph_census.cu``, and the checks) timed in turns; then the
   server's probe kept (``GraphProbe`` checked by ``validate_probe``, what
   ``validate_fn`` runs on the card) and its K1/K2/other nodes and its
   edges by type (full, programmatic), the reader's seconds, its K1/K2
   nodes equal to the census, to its capture's recorded calls and to the
   kernel events of one replay of the validated graph under
   torch.profiler, that replay's rows equal to the CPU engine's, and the
   graph pool's bytes before the probe and after it is dropped; the four malformed programs of ``tests/test_torch_validator.py``
   (every GEMM before any fold, a window folded twice, eager folds audited
   as lazy, a fold in another zone than its GEMM) flagged from their graphs
   with V1/V2, V7, V6 and V3; one fused transform (K3) validated; one eager
   BN254 e2e under torch.profiler with every K1/K2 kernel launched inside a
   ``wzone_*`` range;
8. online — the online server (``serve_crypto_online`` on the card, the
   measured service time, not the modelled one) on the same paper trace in
   three configurations, each run cold and then warm on one co-scheduler:
   (a) ``online_paper``, the defaults, which also writes its Chrome trace
   and OpenMetrics text under ``chiprun_out/`` (cold) and is run once more
   warm under torch.profiler for the device idle share; (b)
   ``online_fastpath``, (a) with the row ladder, the async pipeline, the
   controller, a depth-2 launch ring and λ-holdback; (c)
   ``online_mixed_eager_lazy``, int32 with lazy Dilithium at d = 256.  Each
   prints its counts, every tenant row checked (Dilithium against the int64
   oracle, every row against the slice replay of the same trace), its
   launch census (K1/K2 launches against the fold profiles: program runs,
   capture warm-ups and validation probes; K3 none), latency and queue-wait
   percentiles from the telemetry and per workload, occupancy, the dispatch
   section, captures, peak device memory and the card's name and power
   limit; then ``online_memory``, the device memory in use and the live
   programs before the phase and after it, its co-schedulers dropped;
9. cluster — the multi-host cluster (``serve_crypto_cluster`` on the card,
   every host a ``CryptoServer`` with its own co-scheduler and captured
   programs, all behind one tenant-hash ingress) on the same paper trace in
   three configurations, each run cold (fresh per-host co-schedulers) and
   then warm (the same co-schedulers again): (a) ``cluster_paper``, four
   hosts on the server defaults, which also writes the fleet's Chrome trace
   and OpenMetrics text under ``chiprun_out/`` (cold) and is run once more
   warm under torch.profiler for the device idle share; (b)
   ``cluster_failover``, four hosts on the fast path of (b) above with host
   1 killed at half the trace and recovered at 0.9 of it; (c)
   ``cluster_device_parallel``, two hosts each pinned to its slice of the
   card's devices (one card: both on ``cuda:0``).  Every served row is
   checked against the slice replay (Dilithium also against the int64
   oracle), and (b)'s and (c)'s against (a)'s; the K1/K2 launches against
   the census summed over the hosts (each host's program runs, capture
   warm-ups and validation probes); the drain barrier must be complete with no
   group in flight, the gossip's used staleness within its bound and no
   request lost.  Each prints per-host requests and load imbalance, merged
   latency percentiles (overall and per workload), the wall time, captures
   and capture seconds per host, the graph pool's bytes, peak device memory
   and, for (b), the failover counts and a gather-ring rescue (two hosts,
   a depth-2 ring of launched groups on the killed one, both flights
   gathered at its cordon and their rows checked), for (c), the
   ``devices`` section and the dispatch-overlap audit;
10. examples — each crypto example of ``repro_torch.examples``
   (``quickstart``, ``mixed_workload``, ``multi_tenant_sequencer``,
   ``online_serving``, ``cluster_serving``) run by its ``main`` on the card,
   its checks passed, with its K1/K2/K3 launches and what it printed;
11. dryrun — the dry run's crypto cells (``repro_torch.launch.dryrun``:
   ``aegis_dilithium`` and ``aegis_bn254`` at ``serve_256``, 8 rows ×
   d = 256, and ``serve_8k``, d = 8192),
   each captured as one graph, read, validated (V1–V7), priced by the cost
   model (``repro_torch.launch.graph_cost``: bytes and operations per node
   against the data sheet's rates) and replayed under torch.profiler: K1/K2
   nodes against the fold profile, every output exact, the predicted device
   time beside the launch floor and the profiled device time, the graph
   pool's bytes and the card; then the same four cells planned on 16 × 16
   and 2 × 16 × 16 (``run_cell`` with ``multi_pod``: JAX's rows, 2,048 and
   4,096, over a fake process group, the step a per-device region on
   rank 0's shards under the sharded census), each ``ok`` with JAX's
   record keys and no collective, and rank 0's block (128 rows against
   d ÷ 16 output columns, the ``share``) run on the card as the one-device
   cells are, exact, its K1/K2 nodes equal to the plan's calls a device
   and the fold profile (run once, on 16 × 16, and taken by 2 × 16 × 16,
   whose block is the same); K1 and K2 at the shares' shapes bit for bit
   against their plain versions and timed beside their bounds, the plain
   versions and, for K1, ``torch.matmul`` in f32 (``share_kernels``);
   then the LM cells of the dry run
   (``run_cell`` on the production meshes, planned on the host: a fake
   process group, DTensors under FakeTensorMode, the sharded census):
   olmo_1b ``train_4k`` and ``decode_32k``, mamba2_370m ``long_500k`` and
   one cell per per-device region of the models (internlm2_20b,
   whisper_large_v3, mamba2_370m, moonshot_v1_16b_a3b and
   granite_moe_3b_a800m ``decode_32k``, hymba_1_5b ``long_500k``)
   on 16 × 16 and 2 × 16 × 16, each ``ok`` with its bytes per device,
   roofline terms, collective bytes by kind and plan seconds (K1/K2/K3 at
   0), llama3_405b ``long_500k`` ``skipped``; and the census on this torch
   seeing one local product for a sharded one (``census_local``);
12. lm — the LM serving path (``serve_lm``, ``repro_torch.models``; plain
   PyTorch ops, no Pallas kernel on this path, so K1/K2/K3 must stay at 0
   launches): (a) each of the ten archs at its smoke config in float32,
   drawn on the CPU from the seed and copied to the card, served on both
   with equal greedy tokens, and its train-mode, prefill and first decode
   logits on the card within 1e-4 of the CPU's; (b) for the five archs of
   ``tests/test_models_smoke.py``'s decode test, the decode step's logits
   on the card within its 2e-2 of a full-context forward; (c) olmo_1b at
   its full published width in bf16 (batch 2, prompt 16, 8 tokens): its
   parameter bytes, prefill ms, decode ms per token and tokens/s (CUDA
   events, median of five warm runs after a cold one), peak allocated and
   reserved memory, one more warm run under torch.profiler (kernels,
   device busy ms, idle share, the five largest kernels), and its
   decode-against-full-context and
   bf16-against-float32 errors (the same weights in float32 on the card),
   each as max |err| over the reference's largest |logit| within the 5e-2
   ``PERF.md`` states; (d) granite_moe_3b_a800m, hymba_1_5b, mamba2_370m
   and whisper_large_v3 at full width (tokens in vocabulary, logits
   finite, times and memory), and internvl2_1b's refusal: its 256-patch
   vision prefix overflows the prompt-plus-decode cache, where the JAX
   ``serve_lm`` raises;
13. train — the LM training path (``repro_torch.launch.train``,
   ``repro_torch.examples.train_lm``: AdamW, the train step with remat and
   gradient accumulation, the data stream, checkpoints, the fault-tolerant
   loop; plain PyTorch ops, so K1/K2/K3 must stay at 0 launches): (a) each
   of the ten archs at its smoke config in float32, drawn on the CPU from
   the seed and copied to the card, one train step on both from the same
   state and ``batch_at(0)`` at a learning rate of 1e-3 (so the update
   clears the bound): loss, grad_norm and every updated parameter within
   1e-4, and the moments ``m`` and ``v`` (the clipped gradient and its
   square) leaf by leaf within 1e-4 of that leaf's largest magnitude; and
   olmo_1b's ``grad_accum = 4`` against 1 within 2e-3, the moments at 2e-3
   of each leaf's scale;
   (b) olmo_1b at its full published width in bf16 through
   ``launch.train.build``'s defaults (sequence 128, global batch 8, remat
   "dots"): parameter and optimizer bytes, 12 steps (step ms by CUDA
   events, median of the last 10; tokens/s; every loss finite), peak
   allocated and reserved memory, one more step under torch.profiler
   (kernels, device busy ms and the share under ``aten::mm``/``bmm``/
   ``addmm``, idle share, the five largest kernels), then the first
   step's loss, grad_norm and gradients against the same weights
   in float32 (within 5e-2 relative; every leaf's gradient at cosine ≥
   0.99); no checkpoint at this width (~14 GB a save); (c) the
   ``train_lm`` demo, 100 steps, clean and with ``--inject-fault``
   (checkpoints under ``build/``): one restart, falling losses, the final
   parameters within 1e-5 of the clean run's, the watchdog's median step
   and stragglers; (d) ``python -m
   repro_torch.launch.train --arch olmo_1b --smoke --steps 20`` as a
   subprocess, its summary line and exit code 0; (e) training over a mesh
   (``launch.train.build(mesh=)``) on a one-rank NCCL group: olmo_1b at
   full width in bf16 on ``make_local_mesh()``, (1, 1, 1), three steps from
   seed 0, then three steps of the one-device port from the same seed
   (the memory freed between): step ms (CUDA events, median) of each,
   peak memory, one more step of each under torch.profiler (kernels,
   device busy ms, idle share),
   every loss and grad_norm within the bf16 tolerance of (b), 5e-2
   relative, and every parameter after the third step within 5e-2 of its
   leaf's largest magnitude, with whether they were bit for bit (not
   required: on a one-position mesh DTensor still picks its own strategy
   for some backward products, the gradient of each attention ``wo``
   arriving as ``Shard(0)`` over size-1 dimensions, so those products run
   on another operand layout and round otherwise in the last bits); at smoke
   width, a checkpoint saved from the mesh restored into a one-device
   model, parameters and moments bit for bit; the group torn down before
   the dist phase;
14. dist — the mesh runtime and the W8A8 path, single controller on the
   card (no Pallas kernel on these paths: K1/K2/K3 stay at 0): (a) GPipe
   (``repro_torch.runtime.pipeline``), olmo_1b's 16 layers at full width
   in bf16 as 4 stages of 4 on a ``pod`` axis of 4 positions on the card,
   8 microbatches of (2, 128) hidden states: equal bit for bit to the same
   stages run serially per microbatch, within 5e-2 (of the largest |value|)
   of one pass of all of them at once; pipeline and serial ms (CUDA
   events, median of 5), stage calls, kernels and idle share; (b) the int8
   error-feedback sync (``repro_torch.runtime.compression``) of olmo_1b's
   gradient tree (113 bf16 leaves, 1,176,764,416 elements, seeded) over
   the same axis: every synced leaf and the new error state within the
   leaf's scale (max |g| / 127), the smoke tree's sync on the card equal
   to the CPU's bit for bit, ms per sync, peak memory, bytes sent as int8
   against an int32 psum's; (c) ``QuantizedLinear`` (``repro_torch.quant``)
   on olmo_1b's ``mlp/wi_gate`` (2048 × 8192) with 8 × 128 tokens: the
   card's int32 path (``torch._int_mm``, padded) equal bit for bit to the
   CPU's plain integer path, within 0.05 of the bf16 product, µs against
   ``torch.matmul`` in bf16; an exact-window case (K = 2048) against the
   int64 product; (d) the process-group forms of (a) and (b)
   (``pipeline_forward`` and ``compressed_grad_sync`` given a
   ``DeviceMesh``) on a one-rank NCCL group, a ``pod`` axis of one rank:
   the sync of (b)'s tree and GPipe of (a)'s 16 layers as one stage, each
   bit for bit equal to the single-controller form on a one-position axis,
   with the ms of both; (e) four spawned ranks of one gloo group, every
   rank on the card: the sync of the smoke tree, each rank bit for bit
   equal to the single-controller form it runs itself (gloo cannot send a
   CUDA tensor, so GPipe does not run there).

Eleven short calls run the first phase and stop: ``--k3`` adds K3's checks
and times (for a change to K3), ``--k2`` K2's checks, times and pass spans
and K3's checks (for a change to the fold, which K3 shares), ``--variants``
the variants phase, ``--validator`` the validator phase, ``--online`` the online phase, with the CPU replays of
its two traces as the reference, ``--cluster`` the cluster phase, with
the CPU replay of the paper trace as the reference, ``--examples`` the
examples phase, ``--dryrun`` the dry run's four cells, ``--lm`` the LM
phase and ``--train`` the train phase, ``--dist`` the dist phase.  ``--train --remat-ms`` is the
train phase with a diagnostic that no other call runs: after (b)'s
profiled step, three more steps each with remat off and under "nothing"
(step ms, median).

Every comparison of the crypto phases is exact (tolerance 0); the LM and
train phases' floating-point comparisons use the tolerances stated under 12
and 13, the dist phase's those under 14.
Any failure raises, so the exit code is not 0 and the last line is
missing.  The last two lines are the kernel table
(``{"kernels": [...]}``) and ``{"ok": true, "device": ...}``.
Nothing of JAX or of the JAX package ``repro`` is imported.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import accumulator as ACC                 # noqa: E402
from repro_torch.core import field as F                          # noqa: E402
from repro_torch.core import limb_gemm as G                      # noqa: E402
from repro_torch.core import ntt as NTT                          # noqa: E402
from repro_torch.core import primes as P                         # noqa: E402
from repro_torch.core import rns as R                            # noqa: E402
from repro_torch.core import validator as V                      # noqa: E402
from repro_torch.core import workloads as WK                     # noqa: E402
from repro_torch.core import zones as Z                          # noqa: E402
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler  # noqa: E402
from repro_torch.core.scheduler import (IngressQueue, PoissonTrace,  # noqa: E402
                                        RectangularScheduler, TenantRequest)
from repro_torch.cluster import ClusterConfig, ClusterServer    # noqa: E402
from repro_torch.configs import ARCHS as LM_ARCHS, get_config, smoke_config, torch_dtype  # noqa: E402
from repro_torch.core.scheduler.program import E2EProgram, GraphProbe, capture_pool, host_operand  # noqa: E402
from repro_torch.kernels import build, fused_transform          # noqa: E402
from repro_torch.kernels.fused_ntt_tile.kernel import COUNTER as K3, fused_ntt_tile_cuda, launch_grid  # noqa: E402
from repro_torch.kernels.fused_ntt_tile.ref import fused_ntt_tile_ref  # noqa: E402
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1, grid_blocks, limb_matmul_cuda  # noqa: E402
from repro_torch.kernels.limb_matmul.ops import limb_matmul      # noqa: E402
from repro_torch.kernels.limb_matmul.ref import limb_matmul_ref  # noqa: E402
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2, mont_fold_cuda  # noqa: E402
from repro_torch.kernels.mont_fold.kernel import grid_blocks as k2_grid_blocks  # noqa: E402
from repro_torch.kernels.mont_fold.ops import mont_fold          # noqa: E402
from repro_torch.kernels.mont_fold.ref import mont_fold_ref      # noqa: E402
from repro_torch.launch import dryrun as DRY                   # noqa: E402
from repro_torch.launch import graph_cost as GC                 # noqa: E402
from repro_torch.launch import mesh as MESH                     # noqa: E402
from repro_torch.launch import specs as SPECS                   # noqa: E402
from repro_torch.quant import QuantizedLinear, quantized_matmul  # noqa: E402
from repro_torch.quant.aqt import exact_k_bound                  # noqa: E402
from repro_torch.runtime import compressed_grad_sync, init_error_state  # noqa: E402
from repro_torch.runtime.compression import wire_bytes          # noqa: E402
from repro_torch.runtime.pipeline import bubble_fraction, pipeline_forward  # noqa: E402
from repro_torch.launch.dryrun import oracle_mod_np             # noqa: E402
from repro_torch.launch.serve import lm_prompts, serve_crypto, serve_crypto_cluster, serve_crypto_online, serve_lm  # noqa: E402
from repro_torch.models import model as LM                      # noqa: E402
from repro_torch.models import steps as LMST                    # noqa: E402
from repro_torch.core.scheduler.coscheduler import check_launch_census, expected_kernel_calls  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMStream, batch_to_device  # noqa: E402
from repro_torch.examples import train_lm as TRAIN_LM            # noqa: E402
from repro_torch.launch import train as TRAIN                    # noqa: E402
from repro_torch.optim import (AdamWConfig, global_norm,          # noqa: E402
                               init_opt_state)
from repro_torch.device import partition_devices                # noqa: E402
from repro_torch.examples import EXAMPLES                       # noqa: E402
from repro_torch.obs import validate_chrome_trace, validate_openmetrics  # noqa: E402
from repro_torch.serve import ServeConfig                       # noqa: E402
from repro_torch.serve.client import attach_payloads            # noqa: E402
from repro_torch.serve.server import CryptoServer, coscheduler_from_config  # noqa: E402

Q = F.DILITHIUM_Q
SEED = 0
# The bounds (bytes and operations of a K1/K2/K3 call against the data
# sheet's rates) are the cost model's: repro_torch.launch.graph_cost.
# Back-to-back passes in one CUDA graph for the device spans.
PASSES = 20
# The mixed eager/lazy configuration (tests/test_serve_runtime.py:211-228).
MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
# The online phase's configurations: (serve_crypto_online keywords, d_uniform,
# reference rows).  (b) takes the flags of the fast path and the control
# plane; (c) is the mixed configuration.
ONLINE = {
    "online_paper": ({}, None, "paper"),
    "online_fastpath": (dict(row_ladder_max=16, async_pipeline=True,
                             controller=True, inflight_depth=2,
                             holdback_lambda=1.5), None, "paper"),
    "online_mixed_eager_lazy": (MIXED, 256, "mixed"),
}
# The cluster phase's configurations (serve_crypto_cluster keywords), on the
# paper trace: (a) four hosts on the server defaults; (b) four hosts on (b)
# of the online phase, host 1 killed at half the trace and recovered at 0.9
# of it; (c) two hosts, each pinned to its slice of the card's devices.
FAULT_PLAN = "kill@0.5:h1,recover@0.9:h1"
CLUSTER = {
    "cluster_paper": dict(hosts=4, gossip_period_s=0.002),
    "cluster_failover": dict(hosts=4, gossip_period_s=0.002,
                             fault_plan=FAULT_PLAN,
                             **ONLINE["online_fastpath"][0]),
    "cluster_device_parallel": dict(hosts=2, gossip_period_s=0.002,
                                    device_parallel=True),
}
OUT = Path(__file__).resolve().parent / "chiprun_out"
# The variants phase.  Table 1: the JAX package's rows on the CPU
# (tests/test_workloads_accumulator.py:13-16), copied, and the two models.
TABLE1_JAX = {"tpu_v4_fp32_mantissa": [True, True, True, False, False, False, False],
              "tpu_v5_int32_native": [True] * 7}
ACC_MODELS = ("fp32_mantissa", "int32_native")
# The staged variants: (label, modulus, limbs, negacyclic, d) — Dilithium and
# the 4-limb prime of Fig. 3 — at 8 and 128 rows, under fp32 eager (passes
# of the 171 / 128 ceiling) and int32 lazy with κ = 2 and with one window,
# both on the replay's d_tile = 171.
CROSSOVER_PRIME = P.ntt_friendly_primes(9, 17)[0]
VARIANT_FIELDS = [("dilithium", Q, 3, True, 256), ("dilithium", Q, 3, True, 2048),
                  ("fig3_4limb", CROSSOVER_PRIME, 4, False, 512)]
VARIANT_ROWS = (8, 128)
VARIANT_MODES = [("fp32_mantissa", "eager", None, None),
                 ("int32_native", "lazy", 2, 171),
                 ("int32_native", "lazy", None, 171)]
# Fig. 3 (benchmarks/fig3_crossover.py:23-40): one row, 4 × 4 limbs,
# fp32_mantissa, eager, fused below 1025.
CROSSOVER_DS = (256, 512, 1024, 2048, 4096)
# The dry run's crypto cells (src/repro/launch/dryrun.py:38-42), at the JAX
# defaults (fp32_mantissa, eager, traced).
DRYRUN_CELLS = [(arch, shape) for arch in ("aegis_dilithium", "aegis_bn254")
                for shape in ("serve_256", "serve_8k")]
# The LM phase (repro_torch.models; no Pallas kernel lies on this path).
# (a) every arch at its smoke config, float32, on the card against the CPU,
# same weights: greedy tokens equal, logits within the CPU tests' port-
# against-JAX tolerance; (b) decode against full context on the card for the
# archs of tests/test_models_smoke.py:48-73 at its tolerance; (c) olmo_1b at
# its full published width in bf16 (serve_lm's default), batch 2, prompt 16,
# 8 tokens: times (median of LM_RUNS warm runs), memory, and its errors
# against a full-context forward and against the same weights in float32,
# each max |err| over the reference's largest |logit| (the bound PERF.md
# stated before the first run); (d) the other families at full width that
# fit one card and that the JAX serve_lm serves; internvl2_1b's vision
# prefix (256) plus the prompt overflows the 24-position cache and must
# raise, as the JAX serve_lm does.
LM_SMOKE_TOL = 1e-4
LM_DECODE_ARCHS = ("olmo_1b", "mamba2_370m", "hymba_1_5b", "whisper_large_v3",
                   "granite_moe_3b_a800m")
LM_DECODE_TOL = 2e-2
LM_FULL = "olmo_1b"
LM_BF16_REL_TOL = 5e-2
LM_FULL_OTHERS = ("granite_moe_3b_a800m", "hymba_1_5b", "mamba2_370m",
                  "whisper_large_v3")
LM_REFUSED = "internvl2_1b"
LM_RUNS = 5
# The train phase (repro_torch.optim, data, checkpoint, runtime,
# launch.train, examples.train_lm; no Pallas kernel on this path): (a) each
# arch at its smoke config in float32, one make_train_step step from the
# same weights, state and batch_at(0) on the CPU and on the card under
# TRAIN_SMOKE_OPT, loss, grad_norm and every updated parameter within the
# LM phase's 1e-4, m and v leaf by leaf within 1e-4 + 1e-4 x the leaf's
# largest magnitude, and olmo_1b's grad_accum = 4 against 1 on the card
# within the JAX test's 2e-3 (tests/test_training_substrate.py:149), m and v
# at that leaf-scaled 2e-3; (b) olmo_1b at its full published width in bf16
# through launch.train.build's defaults (sequence 128, global batch 8, lr
# 3e-4, seed 0, remat "dots"), TRAIN_STEPS steps (median of the last
# TRAIN_TIMED), with --remat-ms TRAIN_REMAT_STEPS more under each other
# remat setting (median), then its first step's loss, grad_norm and gradients
# against the same weights in float32: loss and grad_norm within 5e-2
# relative, each leaf's gradient at cosine >= 0.99; (c) the demo of
# examples.train_lm, TRAIN_DEMO_STEPS steps clean and with the injected
# fault, final parameters within JAX's 1e-5 (tests/test_training_substrate
# .py:96-100); (d) the launcher's CLI as a subprocess; (e) olmo_1b at full
# width trained TRAIN_MESH_STEPS steps on a one-rank NCCL mesh (1, 1, 1) and
# as many on one device, within (b)'s bf16 tolerance (DTensor's own
# strategies round some backward products otherwise), and a smoke-width
# checkpoint from the mesh restored on one device, bit for bit.
TRAIN_SMOKE_DATA = dict(seq_len=64, global_batch=8)
# 1e-3 from step 1 (no warmup): the default schedule's 6e-6 at step 1 moves
# no parameter by as much as the 1e-4 bound
TRAIN_SMOKE_OPT = AdamWConfig(lr=1e-3, warmup_steps=1)
TRAIN_ACCUM_TOL = 2e-3
TRAIN_FULL = "olmo_1b"
TRAIN_STEPS = 12
TRAIN_TIMED = 10
TRAIN_REMAT_STEPS = 3
# the ATen ops whose device time is the profiled step's GEMM share
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
TRAIN_BF16_REL_TOL = 5e-2
TRAIN_GRAD_COS = 0.99
TRAIN_LOOP_TOL = 1e-5
TRAIN_DEMO_STEPS = 100
TRAIN_CLI_STEPS = 20
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
TRAIN_MESH_STEPS = 3
# The dist phase (repro_torch.runtime.pipeline, .compression, repro_torch.
# quant; no Pallas kernel on these paths): (a) GPipe, olmo_1b's 16 layers as
# DIST_STAGES stages on a "pod" axis of as many positions on the card,
# DIST_MICRO microbatches of DIST_MB (batch, sequence) hidden states in
# bf16, DIST_RUNS timed runs each of the pipeline and the serial run; (b)
# the int8 error-feedback sync of olmo_1b's gradient tree over the same
# axis, DIST_SYNC_RUNS timed syncs; (c) W8A8 on mlp/wi_gate with
# DIST_AQT_TOKENS (batch, sequence) tokens.
DIST_STAGES = 4
DIST_MICRO = 8
DIST_MB = (2, 128)
DIST_RUNS = 5
DIST_SYNC_RUNS = 3
DIST_AQT_TOKENS = (8, 128)
# The dry run's LM cells on both production meshes (ok), and the cell the
# skip rule refuses.  After olmo_1b and mamba2_370m's long context, one
# full-width cell per per-device region of repro_torch.models: a GQA head
# split (48/8 heads over model = 16), whisper's cross attention (20/20),
# hymba's window ring on a sequence-sharded cache (25/5 heads, 25 SSD
# heads), SSD over a sharded batch, the MoE dispatch expert-parallel (64
# experts) and over MOE_ALT's d_ff shards (40 experts, 24/8 heads).
DRYRUN_LM_CELLS = [("olmo_1b", "train_4k"), ("olmo_1b", "decode_32k"),
                   ("mamba2_370m", "long_500k"),
                   ("internlm2_20b", "decode_32k"),
                   ("whisper_large_v3", "decode_32k"),
                   ("hymba_1_5b", "long_500k"),
                   ("mamba2_370m", "decode_32k"),
                   ("moonshot_v1_16b_a3b", "decode_32k"),
                   ("granite_moe_3b_a800m", "decode_32k")]
DRYRUN_LM_SKIPPED = [("llama3_405b", "long_500k")]

# K1 main-path shapes (N, K, M): Dilithium passes at d = 64, 128, 256, 512
# (tile 171, La = 3, five diagonals, ragged last passes), BN254 d = 64
# (La = 4, seven diagonals), a 128-row ladder launch; then the kernel's
# edges: M not a multiple of its 8-byte B word (the byte-load path), K = 1,
# N = 9 and 16 (a ragged and a second 8-row block).
K1_SHAPES = [(8, 192, 320), (8, 384, 640), (8, 513, 1280), (8, 255, 1280),
             (8, 513, 2560), (8, 510, 2560), (8, 256, 448), (128, 513, 1280),
             (128, 256, 128), (3, 100, 70), (8, 513, 1283), (8, 1, 1280),
             (3, 1, 70), (9, 513, 1280), (16, 256, 448)]
# int32 only (N, K, M, fill): random operands past the fp32 window and past
# one chunk of K (640 k per block); constant operands whose int32 sum
# wraps (fill = (A value, B value)), as test_limb_matmul_int32_wraps_like_int32
# has it: 255·127·131072 and 255·(-128)·65794 both leave int32.
K1_INT32_ONLY = [(8, 1536, 2560, None), (5, 4100, 96, None),
                 (1, 131072, 2, (255, 127)), (8, 65794, 64, (255, -128))]
K1_TIMED = [(8, 513, 1280), (8, 513, 2560), (8, 256, 448)]
K2_TIMED = [(8, 256, 5, Q), (8, 512, 5, Q), (8, 64, 7, R.make_chain(9).base[0])]
# K3 shapes (N, K, D, n_diag, m): the ML-DSA d = 256 passes under fp32
# (K = 513 and 255, at the replay's 8 rows and at 128), BN254 d = 256 (La = 4,
# seven diagonals, a channel modulus), a ragged small case whose 350-byte B
# rows take the byte-load variant, a modulus near 2**31; then the edges of
# the cluster design: K = 1 and 5 (one cluster rank, a partial ring slab), a
# ragged column tile on the bulk variant (d = 70 at 8 diagonals, 560-byte
# rows) and on the byte-load one (d = 33), N = 1 and 129, and n_diag 1, 2,
# 3, 4 and 6 (5, 7 and 8 are above and below); int32-only: the single
# ML-DSA pass (K = 768, past the fp32 window), the largest fused plan
# (Dilithium d = 2048, a 63 MB operand), K = 6145 (no multiple of the slab
# or of the cluster split) and K past the A chunk with eight diagonals.
BN_M = R.make_chain(9).base[0]
# K2's edge cases: every int32 edge on every diagonal, at the smallest
# moduli (2 and 3: most weights 0 or 1), the main path's, and the largest
# (2**31 - 1: 2m is 2**32 - 2, the edge of the fold's 32-bit reduction).
INT32_EDGES = (-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 1)
K2_MODULI = (2, 3, Q, BN_M, (1 << 31) - 99, 2**31 - 1)
K3_SHAPES = [(8, 513, 256, 5, Q), (8, 255, 256, 5, Q), (128, 513, 256, 5, Q),
             (128, 512, 256, 7, BN_M), (3, 100, 70, 5, Q),
             (16, 300, 64, 7, 2**31 - 1),
             (8, 1, 256, 5, Q), (8, 5, 256, 5, Q), (8, 513, 70, 8, Q),
             (8, 300, 33, 5, Q), (1, 513, 256, 5, Q), (129, 513, 256, 7, BN_M),
             (8, 513, 256, 1, Q), (16, 256, 96, 2, Q), (8, 513, 64, 3, Q),
             (8, 300, 128, 4, BN_M), (8, 513, 256, 6, 2**31 - 1)]
K3_INT32_ONLY = [(128, 768, 256, 5, Q), (8, 6144, 2048, 5, Q),
                 (8, 6145, 256, 5, Q), (5, 4100, 96, 8, (1 << 31) - 99)]
K3_TIMED = [(128, 768, 256, 5, Q, "int32_native"),
            (128, 513, 256, 5, Q, "fp32_mantissa"),
            (128, 512, 256, 7, BN_M, "fp32_mantissa"),
            (8, 6144, 2048, 5, Q, "int32_native")]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def bound_ms(kernel: str, card: str, **args) -> tuple:
    """The least time of one K1/K2/K3 call on ``card`` in ms
    (``graph_cost.node_cost`` against the data sheet's rates, the GEMM on
    the int8 tensor cores unless ``fp32`` prices it as FFMA), and what
    bounds it."""
    t, by = GC.bound_s(GC.node_cost(kernel, {"fp32": False, **args}), card)
    return t * 1e3, by


def median_ms(fn, dev, runs=50, per_run=20, warmup=10) -> float:
    """Time of one call of ``fn``: CUDA events around ``per_run``
    back-to-back calls, divided by ``per_run``; the median of ``runs`` such
    runs, after a warm-up.  Host enqueue time is part of it when a call is
    shorter than its launch."""
    return median_ms_turns({"fn": fn}, dev, runs, per_run, warmup)["fn"]


def median_ms_turns(fns: dict, dev, runs=50, per_run=20, warmup=10) -> dict:
    """``median_ms`` of several functions taken in turns: each run times
    every function once, in order, so that the host's noise falls on all of
    them alike.  Calls that are host-bound are compared this way."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize(dev)
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_run):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / per_run)
    return {name: statistics.median(t) for name, t in times.items()}


def device_ms(fn, kernel: str | None, dev, n=50, windows=3) -> float | None:
    """Mean device time of one launch of ``kernel`` (torch.profiler), or,
    with ``kernel=None``, of all the device work of one call of ``fn``.  The
    profiler now and then drops a window's events, so a window that shows
    no device time is profiled again, up to ``windows`` in all; None when
    none shows any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize(dev)
        if kernel is None:
            ms = sum(ev.self_device_time_total for ev in _kernel_events(prof)) / n / 1e3
        else:
            ms = next((ev.self_device_time_total / ev.count / 1e3
                       for ev in prof.key_averages()
                       if kernel in ev.key and ev.count), 0)
        if ms:
            return ms
    return None


def host_us_turns(fns: dict, dev, calls=1000, runs=7, warmup=50) -> dict:
    """Host microseconds per call of each function called back to back: the
    median of ``runs`` runs of ``calls`` calls, each run ended by a
    synchronise, the functions taking turns run by run.  While a call takes
    the host longer than its work takes the device, this is the host's cost
    of one call."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize(dev)
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(dev)
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {name: statistics.median(t) for name, t in times.items()}


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


# --- phases -------------------------------------------------------------------


def phase_env(dev):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    cap = torch.cuda.get_device_capability(dev)
    check(cap == (9, 0), f"compute capability {cap}, the kernels are sm_90a")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    build.entries()
    env = {"phase": "env", "nvidia_smi": smi[0], "nvcc": nvcc[-1],
           "device": torch.cuda.get_device_name(dev), "capability": list(cap),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": time.perf_counter() - t0,
           "library": build.library_path().name,
           "k1_resources": _k1_resources(),
           "k2_resources": _k2_resources(),
           "k3_resources": _k3_resources()}
    emit(env)
    return env


def _k1_resources() -> list:
    """[accumulator, B-load variant, registers, spill store and load bytes,
    static shared memory] of every K1 instance, from the build's ptxas
    report."""
    rows = []
    for r in build.ptxas_report("limb_matmul_kernel"):
        m = re.search(r"limb_matmul_kernelI([fj])Lb([01])E", r["kernel"])
        check(m is not None, f"unexpected K1 instance {r['kernel']}")
        rows.append(["fp32" if m[1] == "f" else "int32",
                     "word" if m[2] == "1" else "bytes", r["registers"],
                     r["spill_stores"], r["spill_loads"], r["smem"]])
    check(len(rows) == 4, f"{len(rows)} K1 instances in the ptxas report")
    return sorted(rows)


def _k2_resources() -> list:
    """[n_diag, registers, spill store and load bytes] of every K2
    instance, from the build's ptxas report."""
    rows = []
    for r in build.ptxas_report("mont_fold_kernel"):
        m = re.search(r"mont_fold_kernelILi(\d)E", r["kernel"])
        check(m is not None, f"unexpected K2 instance {r['kernel']}")
        rows.append([int(m[1]), r["registers"], r["spill_stores"],
                     r["spill_loads"]])
    check(len(rows) == 8, f"{len(rows)} K2 instances in the ptxas report")
    return sorted(rows)


def _k3_resources() -> list:
    """[accumulator, n_diag, variant, registers, spill store and load bytes,
    static shared memory] of every K3 instance, from the build's ptxas
    report."""
    rows = []
    for r in build.ptxas_report("fused_ntt_tile_kernel"):
        m = re.search(r"fused_ntt_tile_kernelI([fj])Li(\d)ELb([01])E", r["kernel"])
        check(m is not None, f"unexpected K3 instance {r['kernel']}")
        rows.append(["fp32" if m[1] == "f" else "int32", int(m[2]),
                     "bulk" if m[3] == "1" else "bytes", r["registers"],
                     r["spill_stores"], r["spill_loads"], r["smem"]])
    check(len(rows) == 32, f"{len(rows)} K3 instances in the ptxas report")
    return sorted(rows)


def phase_kernels(dev, card: str):
    rng = np.random.default_rng(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"limb_matmul": 0}
    n_checked = {"limb_matmul": 0}

    def k1_inputs(n, k, m, fill=None):
        if fill is not None:
            return (torch.full((n, k), fill[0], dtype=torch.uint8, device=dev),
                    torch.full((k, m), fill[1], dtype=torch.int8, device=dev))
        a = torch.as_tensor(rng.integers(0, 256, (n, k), dtype=np.uint8), device=dev)
        b = torch.as_tensor(rng.integers(-128, 128, (k, m)).astype(np.int8), device=dev)
        return a, b

    def k1_check(a, b, accum, what):
        got = limb_matmul_cuda(a, b, accum)
        want = limb_matmul_ref(a, b, accum)
        err = max_abs_err(got, want)
        check(err == 0, f"limb_matmul {accum} {what}: max |err| {err}")
        worst["limb_matmul"] = max(worst["limb_matmul"], err)
        n_checked["limb_matmul"] += 1

    for n, k, m in K1_SHAPES:
        a, b = k1_inputs(n, k, m)
        for accum in ("fp32_mantissa", "int32_native"):
            k1_check(a, b, accum, (n, k, m))
    for n, k, m, fill in K1_INT32_ONLY:
        a, b = k1_inputs(n, k, m, fill)
        if fill is not None:
            exact = fill[0] * fill[1] * k
            wrapped = (exact + 2**31) % 2**32 - 2**31
            check(exact != wrapped and bool(
                (limb_matmul_ref(a, b, "int32_native") == wrapped).all()),
                  f"limb_matmul int32 {(n, k, m)}: the plain version does not "
                  f"wrap {exact} to {wrapped}")
        k1_check(a, b, "int32_native", (n, k, m, fill))
    # the extreme pass: every product 255·(-128), the sum at the fp32 edge
    a = torch.full((8, 513), 255, dtype=torch.uint8, device=dev)
    b = torch.full((513, 1280), -128, dtype=torch.int8, device=dev)
    for accum in ("fp32_mantissa", "int32_native"):
        k1_check(a, b, accum, "extreme (8, 513, 1280)")
    # B whose rows are not 8-byte aligned though M is a multiple of 8: the
    # kernel takes its byte-load path
    a, b = k1_inputs(8, 513, 1280)
    b_odd = torch.empty(b.numel() + 1, dtype=torch.int8, device=dev)[1:].view_as(b)
    b_odd.copy_(b)
    check(b_odd.data_ptr() % 8 != 0 and b_odd.is_contiguous(), "misaligned B")
    for accum in ("fp32_mantissa", "int32_native"):
        k1_check(a, b_odd, accum, "B at an odd address (8, 513, 1280)")

    k1_times = []
    for n, k, m in K1_TIMED:
        a, b = k1_inputs(n, k, m)
        a_f, b_f = a.float(), b.float()
        bound, by = bound_ms("limb_matmul", card, n=n, k=k, m=m)
        # K1 and torch.matmul are both host-bound per call: timed in turns
        ms = median_ms_turns({
            "kernel": lambda: limb_matmul_cuda(a, b, "fp32_mantissa"),
            "library": lambda: torch.matmul(a_f, b_f),
            "plain": lambda: limb_matmul_ref(a, b, "fp32_mantissa")}, dev)
        k1_times.append({
            "shape": [n, k, m], "accum": "fp32_mantissa",
            "kernel_ms": ms["kernel"],
            "kernel_device_ms": device_ms(
                lambda: limb_matmul_cuda(a, b, "fp32_mantissa"),
                "limb_matmul_kernel", dev),
            "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "library_device_ms": device_ms(lambda: torch.matmul(a_f, b_f), None, dev),
            "bound_ms": bound, "bound_by": by,
            "blocks": grid_blocks(n, m)})
    k2 = k2_checks(dev, rng)
    n_checked["mont_fold"], worst["mont_fold"] = k2["checked"], k2["max_abs_err"]
    k2_times = k2_timings(dev, card, rng)
    out = {"phase": "kernels", "checked": n_checked, "max_abs_err": worst,
           "limb_matmul": k1_times, **k2_times,
           "pass_span": pass_spans(dev, rng, k2_times["mont_fold"]),
           "launch_path": _launch_path(dev, *k1_inputs(*K1_TIMED[0]),
                                       k2_inputs(rng, dev, K2_TIMED[0][:3]),
                                       K2_TIMED[0][3])}
    emit(out)
    return out


def k2_inputs(rng, dev, shape, lo=-(2**24), hi=2**24):
    return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32),
                           device=dev)


def int32_edge_rows(rng, nd: int, cap=4096) -> np.ndarray:
    """Rows of nd diagonals drawn from INT32_EDGES: every combination while
    there are at most ``cap``, else each edge on every diagonal at once and
    ``cap`` random combinations."""
    e = np.array(INT32_EDGES, np.int64)
    if len(e) ** nd <= cap:
        idx = np.indices((len(e),) * nd).reshape(nd, -1).T
    else:
        idx = np.concatenate([np.repeat(np.arange(len(e))[:, None], nd, 1),
                              rng.integers(0, len(e), (cap, nd))])
    return np.ascontiguousarray(e[idx], dtype=np.int32)


def k2_checks(dev, rng) -> dict:
    """K2 against its plain version, bit for bit: random and κ-summed
    diagonals, the BN254 channels, every n_diag from 1 to 8 with the int32
    edges at the edge moduli, output counts that are no multiple of the
    block size, and the main-path shapes."""
    worst, n_checked = 0, 0

    def k2_check(diags, m, what):
        nonlocal worst, n_checked
        check(diags.is_contiguous(), "mont_fold_cuda takes contiguous diagonals")
        got = mont_fold_cuda(diags, m)
        want = mont_fold_ref(diags, m)
        err = max_abs_err(got, want)
        check(err == 0, f"mont_fold {what} {tuple(diags.shape)} m={m}: "
                        f"max |err| {err}")
        worst = max(worst, err)
        n_checked += 1

    i32 = 2**31 - 1
    for n, d, nd, m in [(8, 256, 7, 2013265921), (5, 300, 5, Q),
                        (16, 64, 7, (1 << 31) - 99)]:
        k2_check(k2_inputs(rng, dev, (n, d, nd)), m, "sweep")
    for m in R.make_chain(9).moduli:
        k2_check(k2_inputs(rng, dev, (8, 64, 7)), m, "bn254 channel")
    for m in (Q, (1 << 31) - 99):
        k2_check(k2_inputs(rng, dev, (8, 256, 5), -i32, i32 + 1), m, "kappa-summed")
        k2_check(k2_inputs(rng, dev, (8, 256, 5), -i32, 0), m, "all negative")
    for nd in range(1, 9):
        edges = torch.as_tensor(int32_edge_rows(rng, nd), device=dev)
        kappa = k2_inputs(rng, dev, (8, 129, nd), -(2**31), 2**31)
        for m in K2_MODULI:
            k2_check(edges, m, "int32 edges")
            k2_check(kappa, m, "kappa-summed")
    for n_out in (1, 127, 129, 4099):
        for nd, m in ((5, Q), (7, BN_M), (8, 2**31 - 1)):
            k2_check(k2_inputs(rng, dev, (n_out, nd), -(2**31), 2**31), m,
                     "ragged")
    for n, d, nd, m in K2_TIMED:
        k2_check(k2_inputs(rng, dev, (n, d, nd)), m, "main path")
    return {"checked": n_checked, "max_abs_err": worst}


def k2_timings(dev, card: str, rng) -> dict:
    """K2 at each timed shape beside its bound and its plain version, with
    its grid; then the launch floor (an empty kernel's device time, read the
    same way as K2's) and K2's device time over it."""
    rows = []
    for n, d, nd, m in K2_TIMED:
        diags = k2_inputs(rng, dev, (n, d, nd))
        bound, by = bound_ms("mont_fold", card, n_out=n * d, n_diag=nd)
        rows.append({
            "shape": [n, d, nd], "modulus": m, "blocks": k2_grid_blocks(n * d),
            "kernel_ms": median_ms(lambda: mont_fold_cuda(diags, m), dev),
            "kernel_device_ms": device_ms(lambda: mont_fold_cuda(diags, m),
                                          "mont_fold_kernel", dev),
            "plain_ms": median_ms(lambda: mont_fold_ref(diags, m), dev),
            "library_ms": None,   # no single torch call computes the fold
            "bound_ms": bound, "bound_by": by})
    empty_ms = device_ms(build.empty_call(dev), "empty_kernel", dev)
    floor = {"device_ms": empty_ms,
             "mont_fold_ratio": [None if empty_ms is None or t["kernel_device_ms"] is None
                                 else t["kernel_device_ms"] / empty_ms
                                 for t in rows]}
    return {"mont_fold": rows, "empty_launch": floor}


def capture(fn, passes=PASSES):
    """``passes`` back-to-back calls of ``fn`` captured as one CUDA graph:
    the graph and the outputs of every call, all kept alive (so no call
    reuses another's buffers)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(passes)]
    return graph, outs


def graph_spans(graphs: dict, dev, passes=PASSES, runs=50) -> dict:
    """Device time of one call with the host out of the way, from graphs of
    ``passes`` calls (``capture``): each graph replayed between CUDA events,
    the graphs in turns; the median of ``runs`` replays over ``passes``."""
    ms = median_ms_turns({name: g.replay for name, g in graphs.items()}, dev,
                         runs=runs, per_run=1)
    return {name: t / passes for name, t in ms.items()}


def pass_spans(dev, rng, k2_rows: list) -> list:
    """The cost of K2 inside a staging pass.  For each K2 timed shape and
    its K1 partner, three graphs of PASSES passes: K1 then K2 (K2 a
    programmatic dependent of K1), K1 alone, K1 then the empty kernel.  K2's
    marginal cost is span(K1 → K2) − span(K1), set beside its standalone
    device time.  Before the timing, every diagonal and residue buffer of
    the K1 → K2 graph is overwritten, the graph replayed, and each pass's
    residues must equal the eager pass's: a K2 that read before K1's stores
    were visible would fold the overwritten diagonals."""
    empty_call = build.empty_call(dev)
    out = []
    for (n, k, cols), (_, d, nd, m), k2 in zip(K1_TIMED, K2_TIMED, k2_rows):
        check(cols == d * nd, f"K1 {(n, k, cols)} does not feed K2 {(n, d, nd)}")
        a = torch.as_tensor(rng.integers(0, 256, (n, k), dtype=np.uint8), device=dev)
        b = torch.as_tensor(rng.integers(-128, 128, (k, cols)).astype(np.int8),
                            device=dev)

        def k1():
            return limb_matmul_cuda(a, b, "fp32_mantissa").view(n, d, nd)

        def k1_k2():
            diag = k1()
            return diag, mont_fold_cuda(diag, m)

        def k1_empty():
            diag = k1()
            empty_call()
            return diag

        want = k1_k2()[1]
        check(torch.equal(want, mont_fold_ref(
            limb_matmul_ref(a, b, "fp32_mantissa").view(n, d, nd), m)),
              f"eager K1 -> K2 at {(n, k, cols)} differs from the plain versions")
        graph, passes = capture(k1_k2)
        for diag, res in passes:
            diag.fill_(2**31 - 1)
            res.fill_(-1)
        graph.replay()
        torch.cuda.synchronize(dev)
        check(all(torch.equal(res, want) for _, res in passes),
              f"graph K1 -> K2 at {(n, k, cols)} differs from the eager pass")
        span = graph_spans({"k1_k2": graph, "k1": capture(k1)[0],
                            "k1_empty": capture(k1_empty)[0]}, dev)
        marginal = span["k1_k2"] - span["k1"]
        out.append({"k1_shape": [n, k, cols], "k2_shape": [n, d, nd],
                    "modulus": m, "passes": PASSES, "span_ms": span,
                    "k2_marginal_ms": marginal,
                    "empty_marginal_ms": span["k1_empty"] - span["k1"],
                    "k2_device_ms": k2["kernel_device_ms"],
                    "pdl_hides": (k2["kernel_device_ms"] is not None
                                  and marginal < k2["kernel_device_ms"]),
                    "graph_equals_eager": True})
    return out


def _launch_path(dev, a, b, diags, m) -> dict:
    """Host µs of one K1 call at the first timed shape (fp32), back to back,
    layer by layer: the bare ctypes launch with its entry, pointers, device
    index and stream resolved in advance; the output's allocation alone; the
    ``limb_matmul_cuda`` wrapper (allocation, stream lookup, launch); the
    full ``ops.limb_matmul`` call (its checks on top); and ``torch.matmul``
    on the same operands as floats.  K2's full ``ops.mont_fold`` call at its first timed shape is
    beside them.  All take turns (``host_us_turns``).  The bare launches go
    around the wrappers, so no counter sees them."""
    n, k = a.shape
    m_cols = b.shape[1]
    out = torch.empty((n, m_cols), dtype=torch.int32, device=dev)
    fn = build.entries()["limb_matmul_launch"]
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), n, k, m_cols, 1,
            dev.index, build.current_stream(dev.index))

    def bare():
        build.check(fn(*args), "limb_matmul")

    bare()
    check(torch.equal(out, limb_matmul_ref(a, b, "fp32_mantissa")),
          "bare K1 launch differs from the plain version")
    a_f, b_f = a.float(), b.float()
    us = host_us_turns({
        "bare_launch_us": bare,
        "alloc_us": lambda: a.new_empty((n, m_cols), dtype=torch.int32),
        "wrapper_us": lambda: limb_matmul_cuda(a, b, "fp32_mantissa"),
        "ops_us": lambda: limb_matmul(a, b, accum="fp32_mantissa"),
        "library_us": lambda: torch.matmul(a_f, b_f),
        "mont_fold_ops_us": lambda: mont_fold(diags, m)}, dev)
    return {"shape": [n, k, m_cols], "accum": "fp32_mantissa",
            "mont_fold_shape": list(diags.shape), **us}


def _oracle_int64(a: np.ndarray, d: int) -> np.ndarray:
    """(a @ W) mod Q for the Dilithium NTT matrix of degree d."""
    w = NTT.ntt_matrix(d, Q, negacyclic=(Q - 1) % (2 * d) == 0)
    return oracle_mod_np(a, w, Q).astype(np.uint32)


def phase_engines(dev):
    rng = np.random.default_rng(SEED + 1)
    rows = 0
    for d in (64, 128, 256, 512):
        a = rng.integers(0, Q, (8, d), dtype=np.uint64).astype(np.uint32)
        want = _oracle_int64(a, d)
        for kw in (dict(accum="fp32_mantissa"),
                   dict(accum="int32_native", reduction="lazy", kappa=2,
                        d_tile=171)):
            eng = WK.DilithiumEngine(d, device=dev, **kw)
            got = eng.e2e(a).cpu().numpy().astype(np.uint32)
            check(np.array_equal(got, want), f"DilithiumEngine d={d} {kw}")
            rows += len(a)
    # per-plane mode (no fused operand: one K1 launch per limb pair), which
    # only degrees above 2048 reach in the engines
    a = rng.integers(0, Q, (8, 256), dtype=np.uint64).astype(np.uint32)
    planar = G.make_channel_plan(
        NTT.ntt_matrix(256, Q, negacyclic=True), Q, data_limbs=3, tw_limbs=3,
        accum="int32_native", fuse_below=0)
    y, _ = G.staged_transform(torch.as_tensor(a.astype(np.int64), device=dev),
                              planar, d_max=171)
    check(np.array_equal(y.cpu().numpy().astype(np.uint32),
                         _oracle_int64(a, 256)), "per-plane staged transform")
    gpu, cpu = WK.BN254Engine(64, device=dev), WK.BN254Engine(64, device="cpu")
    vals = np.array([[int(x) for x in row] for row in
                     rng.integers(0, 2**31, (8, 64))], object)
    got = gpu.e2e(gpu.ingest(vals)).cpu()
    want = cpu.e2e(cpu.ingest(vals))
    check(torch.equal(got, want), "BN254Engine d=64 cuda vs cpu")
    out = {"phase": "engines", "dilithium_rows": rows, "per_plane_rows": len(a),
           "bn254_rows": len(vals),
           "exact": True}
    emit(out)
    return out


@contextlib.contextmanager
def _counted():
    """The K1/K2/K3 counters set to 0 for the block and a launch log open
    over it; after the block, the dict it yields holds the counters'
    launches and the log's calls, which must agree."""
    _reset_counters()
    got = {}
    with Z.launch_log() as log:
        yield got
    got.update({name: c.launches for name, c in
                (("limb_matmul", K1), ("mont_fold", K2), ("fused_ntt_tile", K3))
                if c.launches})
    logged = collections.Counter(r.kernel for r in log.records)
    check(got == dict(logged), f"launches {got}, launch log {dict(logged)}")


def _table1(dev, env: dict) -> dict:
    """Table 1 on the card: K1's two rows (``table1_rows``), beside K1's
    plain version on the card and on the CPU, the sum each returned per
    target, and K1's time at the two widest probe shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with _counted() as launched:
        rows = ACC.table1_rows(device=dev)
    check(launched == {"limb_matmul": 2 * len(ACC.TABLE1_TARGETS)},
          f"table1: {launched} for 14 probes")
    cpu_rows = ACC.table1_rows(device="cpu")
    check(cpu_rows == TABLE1_JAX,
          f"table1: the CPU rows {cpu_rows} differ from the JAX package's")
    sums, plain_card = [], {accum: [] for accum in ACC_MODELS}
    for s in ACC.TABLE1_TARGETS:
        lhs, rhs = ACC._operands_for_target(s)
        a, b = torch.as_tensor(lhs, device=dev), torch.as_tensor(rhs, device=dev)
        entry = {"s": s, "k": lhs.shape[1]}
        for accum in ACC_MODELS:
            plain = int(limb_matmul_ref(a, b, accum)[0, 0])
            plain_card[accum].append(plain == -s)
            entry[accum] = {"k1": ACC.probe_sum(s, accum, device=dev),
                            "plain_card": plain,
                            "plain_cpu": ACC.probe_sum(s, accum, device="cpu")}
        sums.append(entry)
    fp32_key, int32_key = TABLE1_JAX
    plain = {key: plain_card[accum] for key, accum in zip(TABLE1_JAX, ACC_MODELS)}
    for label, got in (("K1", rows), ("plain, card", plain), ("plain, CPU", cpu_rows)):
        check(got[fp32_key][:5] == TABLE1_JAX[fp32_key][:5],
              f"table1 {label}: fp32 entries up to 2**25 - 1 are {got[fp32_key][:5]}")
        check(all(got[int32_key]), f"table1 {label}: int32 row {got[int32_key]}")
    check([e["fp32_mantissa"]["k1"] == -e["s"] for e in sums] == rows[fp32_key],
          "table1: K1's sums and its row differ")
    out = {"phase": "variants", "part": "table1", "k1": rows,
           "plain_card": plain, "plain_cpu": cpu_rows,
           # the two fp32 entries past the window that K1's order decides
           "fp32_beyond_window": {
               str(s): {"k1": rows[fp32_key][i], "plain_card": plain[fp32_key][i]}
               for i, s in enumerate(ACC.TABLE1_TARGETS) if s in (2**28, 2**30)},
           "sums": sums, "launches": launched,
           "k1_probe_shape": _k1_probe_times(dev, env["device"]),
           "nvidia_smi": env["nvidia_smi"]}
    emit(out)
    return out


def _k1_probe_times(dev, card: str) -> list:
    """K1 at the shapes of the 2**28 and 2**30 probes, (1, K) × (K, 1) with
    K = 8,356 and 33,419: one block whose 128 threads each sum K / 128 k,
    under both models, timed in turns with its plain version and
    ``torch.matmul`` on the same operands as floats, beside the bound."""
    out = []
    for s in (2**28, 2**30):
        lhs, rhs = ACC._operands_for_target(s)
        a, b = torch.as_tensor(lhs, device=dev), torch.as_tensor(rhs, device=dev)
        a_f, b_f = a.float(), b.float()
        k = lhs.shape[1]
        bound, by = bound_ms("limb_matmul", card, n=1, k=k, m=1)
        for accum in ACC_MODELS:
            ms = median_ms_turns({
                "kernel": lambda: limb_matmul_cuda(a, b, accum),
                "plain": lambda: limb_matmul_ref(a, b, accum),
                "library": lambda: torch.matmul(a_f, b_f)}, dev)
            out.append({
                "shape": [1, k, 1], "accum": accum, "kernel_ms": ms["kernel"],
                "kernel_device_ms": device_ms(
                    lambda: limb_matmul_cuda(a, b, accum), "limb_matmul_kernel", dev),
                "plain_ms": ms["plain"], "library_ms": ms["library"],
                "library_device_ms": device_ms(lambda: torch.matmul(a_f, b_f),
                                               None, dev),
                "bound_ms": bound, "bound_by": by,
                "blocks": grid_blocks(1, 1)})
    return out


def _staged_variants(dev) -> dict:
    """``staged_transform_traced`` and ``staged_transform_scan`` on the card
    for every field, row count and accumulator mode of VARIANT_*: each equal
    to ``staged_transform`` on the same per-plane plan, to the int64 oracle
    and (d = 256) to ``matrix_transform_ref`` on the CPU, with its K1 and K2
    launches counted (counters and launch log) against passes × La·Lw and
    the folds (the scan form's padded passes included)."""
    rng = np.random.default_rng(SEED + 6)
    runs = []
    for label, m, limbs, negacyclic, d in VARIANT_FIELDS:
        w = NTT.ntt_matrix(d, m, negacyclic=negacyclic)
        base = G.make_channel_plan(w, m, data_limbs=limbs, tw_limbs=limbs,
                                   fuse_below=0)
        w_dev = torch.as_tensor(base.w_planes, device=dev)
        a_np = rng.integers(0, m, (max(VARIANT_ROWS), d), dtype=np.uint64)
        want = oracle_mod_np(a_np, w, m)
        if d == 256:
            ref = G.matrix_transform_ref(torch.as_tensor(a_np.astype(np.int64)),
                                         torch.as_tensor(w.astype(np.int64)), m)
            check(np.array_equal(ref.numpy(), want),
                  f"matrix_transform_ref {label} d={d} differs from the oracle")
        a_all = torch.as_tensor(a_np.astype(np.int64), device=dev)
        for n in VARIANT_ROWS:
            a = a_all[:n]
            for accum, reduction, kappa, d_max in VARIANT_MODES:
                plan = dataclasses.replace(base, accum=accum)
                kw = dict(modulus=m, data_limbs=limbs, accum=accum,
                          reduction=reduction, kappa=kappa, d_max=d_max)
                y_ref, stats = G.staged_transform(
                    a, plan, reduction=reduction, kappa=kappa, d_max=d_max,
                    planes=(w_dev, None))
                check(np.array_equal(y_ref.cpu().numpy(), want[:n]),
                      f"staged_transform {label} d={d} {kw} differs from the oracle")
                passes, k_eff = stats["n_passes"], stats["kappa"]
                padded = -(-passes // k_eff) * k_eff
                run = {"field": label, "d": d, "rows": n, "accum": accum,
                       "reduction": reduction, "kappa": kappa, "d_max": d_max,
                       "passes": passes}
                for name, fn, n_pass, n_fold in (
                        ("traced", G.staged_transform_traced, passes, stats["n_folds"]),
                        ("scan", G.staged_transform_scan, padded,
                         padded if reduction == "eager" else padded // k_eff)):
                    with _counted() as got:
                        y = fn(a, w_dev, **kw)
                    check(got == {"limb_matmul": n_pass * limbs * limbs,
                                  "mont_fold": n_fold},
                          f"{name} {label} d={d} {kw}: calls {got}, expected "
                          f"{n_pass} passes × {limbs * limbs} K1, {n_fold} K2")
                    check(torch.equal(y, y_ref) and np.array_equal(
                        y.cpu().numpy(), want[:n]),
                          f"{name} {label} d={d} rows={n} {kw} is not exact")
                    run[name] = {"passes": n_pass, **got}
                runs.append(run)
    out = {"phase": "variants", "part": "staged_variants", "runs": runs,
           "exact": True}
    emit(out)
    return out


def _crossover(dev, env: dict) -> dict:
    """Fig. 3 on the card: the matrix form (``staged_transform``, K1 + K2
    per pass), Cooley–Tukey (plain torch ops) and, where the plan is fused
    (d <= 1024), ``fused_transform`` (K3) on one row at the widths of
    ``benchmarks/fig3_crossover.py``; each exact, then timed op by op and as
    one captured CUDA graph, both in turns, median of 50."""
    rng = np.random.default_rng(SEED + 7)
    m = CROSSOVER_PRIME
    rows = []
    for d in CROSSOVER_DS:
        a_np = rng.integers(0, m, (1, d), dtype=np.uint64)
        plan = G.make_channel_plan(NTT.ntt_matrix(d, m), m, data_limbs=4,
                                   tw_limbs=4, fuse_below=1025)
        planes = G.plane_operands(plan, dev)
        a = torch.as_tensor(a_np.astype(np.int64), device=dev)
        forms = {"matrix": lambda: G.staged_transform(a, plan, planes=planes)[0],
                 "ct": lambda: NTT.cooley_tukey_ntt(a, m)}
        if plan.fused_operand is not None:
            forms["fused"] = lambda: fused_transform(a, plan, planes=planes)
        calls, kernels, ys = {}, {}, {}
        for name, fn in forms.items():
            with _counted() as calls[name]:
                ys[name] = fn()
            kernels[name] = _kernels_per_call(fn, dev)
        check(all(torch.equal(y, ys["ct"]) for y in ys.values()),
              f"crossover d={d}: the forms differ")
        if d <= 1024:
            check(np.array_equal(ys["ct"].cpu().numpy(),
                                 NTT.cooley_tukey_oracle_np(a_np, m).astype(np.int64)),
                  f"crossover d={d}: Cooley–Tukey differs from the bignum oracle")
        check(calls["matrix"] == {"limb_matmul": plan.n_passes * plan.gemms_per_pass,
                                  "mont_fold": plan.n_passes}
              and not calls["ct"]
              and calls.get("fused", {}) == ({"fused_ntt_tile": plan.n_passes}
                                             if "fused" in forms else {}),
              f"crossover d={d}: launches {calls}")
        graphs = {}
        for name, fn in forms.items():
            graph, (y,) = capture(fn, passes=1)
            y.fill_(-1)
            graph.replay()
            torch.cuda.synchronize(dev)
            check(torch.equal(y, ys[name]), f"crossover d={d}: graph {name} differs")
            graphs[name] = graph
        op_ms = median_ms_turns(forms, dev, runs=50, per_run=1, warmup=3)
        graph_ms = graph_spans(graphs, dev, passes=1)
        rows.append({"d": d, "passes": plan.n_passes,
                     "mode": "per-plane" if plan.fused_operand is None else "fused",
                     "op_ms": op_ms, "graph_ms": graph_ms,
                     "ratio_matrix_to_ct": {"op": op_ms["matrix"] / op_ms["ct"],
                                            "graph": graph_ms["matrix"] / graph_ms["ct"]},
                     "launches": calls,
                     "device_kernels_per_call": kernels,
                     "exact": True})
        del graphs
    for prev, row in zip(rows, rows[1:]):
        row["matrix_scaling"] = {
            kind: row[f"{kind}_ms"]["matrix"] / prev[f"{kind}_ms"]["matrix"]
            for kind in ("op", "graph")}
    out = {"phase": "variants", "part": "crossover", "modulus": m,
           "limbs": [4, 4], "fuse_below": 1025, "rows": 1, "points": rows,
           "o_d2_predicts": 4.0, "nvidia_smi": env["nvidia_smi"]}
    emit(out)
    return out


def phase_variants(dev, env: dict) -> dict:
    """The deferred core variants on the card, one line per part: Table 1
    through K1, the traced and scan staged transforms, the Fig. 3
    crossover.  Each checked run is driven with the K1/K2/K3 counters set
    to 0 just before it and read just after (``_counted``); the timing
    runs are not counted."""
    return {"table1": _table1(dev, env), "staged_variants": _staged_variants(dev),
            "crossover": _crossover(dev, env)}


def k3_inputs(rng, dev, n, k, d, nd):
    a = torch.as_tensor(rng.integers(0, 256, (n, k), dtype=np.uint8), device=dev)
    b3 = torch.as_tensor(rng.integers(-128, 128, (k, d, nd)).astype(np.int8),
                         device=dev)
    return a, b3


def k3_checks(dev, rng) -> dict:
    """K3 against its plain version, bit for bit, at every K3 case: the
    count of cases, the worst error, and which load variants, cluster sizes
    and diagonal counts the cases reached (each is required)."""
    worst, n_checked = 0, 0
    variants, clusters, n_diags = {}, set(), set()

    def k3_check(a, b3, m, accum, what):
        nonlocal worst, n_checked
        got = fused_ntt_tile_cuda(a, b3, m, accum)
        want = fused_ntt_tile_ref(a, b3, m, accum)
        err = max_abs_err(got, want)
        check(err == 0, f"fused_ntt_tile {accum} {what} m={m}: max |err| {err}")
        worst = max(worst, err)
        n_checked += 1
        (n, k), (_, d, nd) = a.shape, b3.shape
        grid = launch_grid(n, k, d, nd, b3)
        variants[grid["variant"]] = variants.get(grid["variant"], 0) + 1
        clusters.add(grid["cluster"])
        n_diags.add(nd)

    for n, k, d, nd, m in K3_SHAPES:
        a, b3 = k3_inputs(rng, dev, n, k, d, nd)
        for accum in ("fp32_mantissa", "int32_native"):
            k3_check(a, b3, m, accum, (n, k, d, nd))
    for n, k, d, nd, m in K3_INT32_ONLY:
        a, b3 = k3_inputs(rng, dev, n, k, d, nd)
        k3_check(a, b3, m, "int32_native", (n, k, d, nd))
    # B one byte off the 16-byte grid, though its rows are 1280 bytes: the
    # byte-load variant at a main-path shape
    a, b3 = k3_inputs(rng, dev, 8, 513, 256, 5)
    b3_odd = torch.empty(b3.numel() + 1, dtype=torch.int8, device=dev)[1:].view_as(b3)
    b3_odd.copy_(b3)
    check(b3_odd.data_ptr() % 16 != 0 and b3_odd.is_contiguous(), "misaligned B")
    for accum in ("fp32_mantissa", "int32_native"):
        k3_check(a, b3_odd, Q, accum, "B at an odd address (8, 513, 256, 5)")
    # the extreme pass: every product 255·(-128), each diagonal at the fp32 edge
    a = torch.full((8, 513), 255, dtype=torch.uint8, device=dev)
    b3 = torch.full((513, 256, 5), -128, dtype=torch.int8, device=dev)
    for accum in ("fp32_mantissa", "int32_native"):
        for m in (Q, 2**31 - 1):
            k3_check(a, b3, m, accum, "extreme (8, 513, 256, 5)")
    # int32 wrap past the window: 255·127·70000 > 2**31 wraps to a negative
    # diagonal before the fold
    a = torch.full((2, 70000), 255, dtype=torch.uint8, device=dev)
    b3 = torch.full((70000, 32, 5), 127, dtype=torch.int8, device=dev)
    for m in (Q, (1 << 31) - 99, 2**31 - 1):
        k3_check(a, b3, m, "int32_native", "int32 wrap (2, 70000, 32, 5)")
    check(set(variants) == {"bulk", "bytes"}, f"K3 variants reached: {variants}")
    check(1 in clusters and max(clusters) > 1, f"K3 clusters reached: {clusters}")
    check(n_diags == set(range(1, 9)), f"K3 n_diag reached: {n_diags}")
    return {"checked": n_checked, "max_abs_err": worst, "variants": variants,
            "clusters": sorted(clusters)}


def k3_timings(dev, card: str, rng) -> list:
    """K3 at each timed shape beside its bound, its plain version and the
    unfused pair K1 + K2 on the same pass, with its launch geometry."""
    k3_times = []
    for n, k, d, nd, m, accum in K3_TIMED:
        a, b3 = k3_inputs(rng, dev, n, k, d, nd)
        b2 = b3.view(k, d * nd)

        def fused():
            return fused_ntt_tile_cuda(a, b3, m, accum)

        def pair():
            return mont_fold_cuda(limb_matmul_cuda(a, b2, accum).view(n, d, nd), m)

        check(torch.equal(fused(), pair()), f"K3 != K1 + K2 at {(n, k, d, nd)}")
        # the int8 GEMM on the tensor cores plus the fold on the CUDA cores;
        # for fp32_mantissa also the GEMM as FFMA, as that model runs it
        bound, by = bound_ms("fused_ntt_tile", card, n=n, k=k, d=d, n_diag=nd)
        # K3 and the pair are compared, so each clock takes them in turns.
        # The pair's device time is its span in a graph: K2 is a
        # programmatic dependent of K1, so the profiler's K2 duration holds
        # its wait on K1 and the two durations do not add up.
        ms = median_ms_turns({"fused": fused, "pair": pair}, dev)
        span = graph_spans({"fused": capture(fused)[0],
                            "pair": capture(pair)[0]}, dev)
        k3_times.append({
            "shape": [n, k, d, nd], "accum": accum, "modulus": m,
            **launch_grid(n, k, d, nd, b3),
            "kernel_ms": ms["fused"],
            "kernel_device_ms": device_ms(fused, "fused_ntt_tile_kernel", dev),
            "span_ms": span["fused"],
            "plain_ms": median_ms(lambda: fused_ntt_tile_ref(a, b3, m, accum), dev),
            # no single torch call computes the GEMM and the fold together
            "library_ms": None,
            "bound_ms": bound, "bound_by": by,
            "ffma_bound_ms": (bound_ms("fused_ntt_tile", card, n=n, k=k, d=d,
                                       n_diag=nd, fp32=True)[0]
                              if accum == "fp32_mantissa" else None),
            "unfused_ms": ms["pair"],
            "unfused_span_ms": span["pair"]})
    return k3_times


def phase_fused(dev, card: str):
    """K3 against its plain version, the fused transform at full width with
    K3's launches counted per call, and the times."""
    rng = np.random.default_rng(SEED + 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    checks = k3_checks(dev, rng)

    # The fused path at full width, K3's launches counted in each call.
    launches, transforms = 0, []

    def fused_run(label, a, plan, planes):
        nonlocal launches
        K1.reset()
        K2.reset()
        K3.reset()
        y = fused_transform(a, plan, planes=planes)
        torch.cuda.synchronize(dev)
        passes = len(plan.tile_bounds())
        check(K3.launches == passes and K1.launches == K2.launches == 0,
              f"{label}: K3 launched {K3.launches} times for {passes} passes "
              f"(K1 {K1.launches}, K2 {K2.launches})")
        launches += K3.launches
        return y, passes

    a_np = rng.integers(0, Q, (128, 256), dtype=np.uint64).astype(np.uint32)
    a_mldsa = torch.as_tensor(a_np.astype(np.int64), device=dev)
    want = _oracle_int64(a_np, 256)
    w = NTT.ntt_matrix(256, Q, negacyclic=True)
    mldsa = {}
    for accum, want_passes in (("fp32_mantissa", 2), ("int32_native", 1)):
        plan = G.make_channel_plan(w, Q, data_limbs=3, tw_limbs=3, accum=accum)
        planes = G.plane_operands(plan, dev)
        y, passes = fused_run(f"ml-dsa {accum}", a_mldsa, plan, planes)
        check(passes == want_passes, f"ml-dsa {accum}: {passes} passes")
        check(np.array_equal(y.cpu().numpy().astype(np.uint32), want),
              f"fused transform ml-dsa d=256 {accum} differs from the oracle")
        mldsa[accum] = (plan, planes)
        transforms.append({"config": f"ml-dsa d=256 {accum}", "rows": 128,
                           "passes": passes, "launches": passes,
                           "against": "int64 oracle"})

    a_np = rng.integers(0, Q, (8, 2048), dtype=np.uint64).astype(np.uint32)
    plan = G.make_channel_plan(NTT.ntt_matrix(2048, Q, negacyclic=True), Q,
                               data_limbs=3, tw_limbs=3, accum="int32_native")
    y, passes = fused_run("dilithium d=2048", torch.as_tensor(
        a_np.astype(np.int64), device=dev), plan, G.plane_operands(plan, dev))
    check(passes == 1 and np.array_equal(y.cpu().numpy().astype(np.uint32),
                                         _oracle_int64(a_np, 2048)),
          "fused transform dilithium d=2048 differs from the oracle")
    transforms.append({"config": "dilithium d=2048 int32_native", "rows": 8,
                       "passes": passes, "launches": passes,
                       "operand_bytes": plan.fused_operand.nbytes,
                       "against": "int64 oracle"})
    del plan

    eng = WK.BN254Engine(256, device=dev)
    vals = np.array([[int.from_bytes(rng.bytes(16), "little") for _ in range(256)]
                     for _ in range(128)], object)
    a_res = eng.ingest(vals)
    outs, bn_launches = [], 0
    for ci, (plan, planes) in enumerate(zip(eng.plans, eng.device_planes())):
        y, passes = fused_run(f"bn254 channel {ci}", a_res[..., ci], plan, planes)
        outs.append(y)
        bn_launches += passes
    y = torch.stack(outs, dim=-1)
    check(torch.equal(y, eng.evaluate(a_res)),
          "fused transform bn254 d=256 differs from the K1 + K2 engine path")
    check(torch.equal(eng.reduce(y), eng.e2e(a_res)),
          "rns_to_field of the fused channels differs from the engine's e2e")
    a8, y8 = a_res[:8].cpu().numpy(), y[:8].cpu().numpy()
    for ci, m in enumerate(eng.chain.moduli):
        w_ch = (eng.omega.astype(object) % m).astype(np.uint32)
        check(np.array_equal(y8[..., ci].astype(np.uint32),
                             NTT.matrix_ntt_oracle_np(a8[..., ci], w_ch, m)),
              f"fused transform bn254 channel {ci} differs from the oracle")
    transforms.append({"config": "bn254 d=256 fp32_mantissa, 9 channels",
                       "rows": 128, "passes": eng.n_passes,
                       "launches": bn_launches,
                       "against": "K1 + K2 engine, e2e, bignum oracle (8 rows)"})

    k3_times = k3_timings(dev, card, rng)
    transform_ms = {}
    for accum, (plan, planes) in mldsa.items():
        transform_ms[accum] = {
            "passes": plan.n_passes,
            "fused_ms": median_ms(lambda: fused_transform(a_mldsa, plan, planes=planes),
                                  dev, runs=20, per_run=5),
            "staged_ms": median_ms(lambda: G.staged_transform(a_mldsa, plan, planes=planes),
                                   dev, runs=20, per_run=5)}
    out = {"phase": "fused", **checks, "transforms": transforms, "launches": launches,
           "fused_ntt_tile": k3_times, "transform_ms_128_rows": transform_ms}
    emit(out)
    return out


def _replay(cos, **kw):
    return serve_crypto(duration_s=0.25, rate_hz=4096, n_c=8, seed=SEED,
                        validate=True, coscheduler=cos, **kw)


def _reset_counters():
    for counter in (K1, K2, K3):
        counter.reset()


def _census(cos, runs: dict, captures_before: dict, probes: int = 0) -> dict:
    """K1/K2 launches a run must have enqueued: for each (workload,
    d_bucket), its program runs, its new captures (each capture's warm-up
    runs the e2e once) and ``probes`` validation probes, times the calls of one
    e2e (the fold profile)."""
    want = {"limb_matmul": 0, "mont_fold": 0}
    for key, n in runs.items():
        k1, k2 = expected_kernel_calls(cos.engine_for(*key))
        n += cos.trace_counts[key] - captures_before.get(key, 0) + probes
        want["limb_matmul"] += n * k1
        want["mont_fold"] += n * k2
    return want


def _program_census(cos, label: str) -> int:
    """Every captured program's recorded K1/K2 calls and launches equal its
    engine's fold profile, and it made no K3 call; returns the programs."""
    n = 0
    for key in cos.trace_counts:
        for shape, prog in cos.jitted_for(*key).items():
            want = expected_kernel_calls(prog.eng)
            got = [(prog.calls[k], prog.launches[k])
                   for k in ("limb_matmul", "mont_fold", "fused_ntt_tile")]
            check(got == [(want[0], want[0]), (want[1], want[1]), (0, 0)],
                  f"{label}: program {key} {shape} recorded {got}, the fold "
                  f"profile says {want}")
            n += 1
    return n


def _check_rows(label: str, results, cpu_rows: dict, oracle: dict):
    """Every tenant row against the CPU replay's, Dilithium also against
    the int64 oracle."""
    for r in results:
        w, d = r.batch.workload, r.batch.d_bucket
        if w == "dilithium":
            a = np.zeros((r.batch.n_c, d), np.uint32)
            for i, req in enumerate(r.batch.requests):
                a[i, :req.degree] = req.coeffs
            if d not in oracle:
                oracle[d] = NTT.ntt_matrix(
                    d, Q, negacyclic=(Q - 1) % (2 * d) == 0).astype(np.int64)
            want = ((a.astype(np.int64) @ oracle[d]) % Q).astype(np.uint32)
            check(np.array_equal(np.asarray(r.rows), want),
                  f"{label}: dilithium d={d} rows differ from the oracle")
        for tid, row in r.outputs.items():
            check(np.array_equal(row, cpu_rows[tid]),
                  f"{label}: tenant {tid} differs from the CPU replay")


def phase_slice(dev, label: str, d_uniform=None, **cos_kw):
    """The replay on the card twice with one co-scheduler: cold (each
    program captured at its first launch height) and warm (every launch a
    replay, nothing captured).  Each run has the kernel counters at 0 and is
    checked row by row and launch by launch; returns the cold run's counts
    and times (a fresh co-scheduler, as a first replay has always been
    measured), with the warm run's beside them under ``warm``."""
    cos = SliceCoScheduler(device=dev, **cos_kw)
    cpu_rows = _cpu_rows(d_uniform, **cos_kw)
    oracle, runs = {}, {}
    for phase in ("cold", "warm"):
        captures = dict(cos.trace_counts)
        _reset_counters()
        results, n_ops, wall = _replay(cos, d_uniform=d_uniform)
        torch.cuda.synchronize(dev)
        launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches}
        check(K3.launches == 0, f"{label}: the replay launched K3 "
              f"{K3.launches} times; it runs K1 and K2 only")
        dispatches = {}
        for r in results:
            key = (r.batch.workload, r.batch.d_bucket)
            dispatches[key] = dispatches.get(key, 0) + 1
        # serve_crypto validates every class it dispatches with one probe
        want = _census(cos, dispatches, captures, probes=1)
        check(launches == want and all(want.values()),
              f"{label} {phase}: launches {launches} != the census {want}")
        _check_rows(f"{label} {phase}", results, cpu_rows, oracle)
        runs[phase] = {"wall_s": wall, "ops_per_s": n_ops / wall,
                       "launches": launches,
                       "captures": sum(cos.trace_counts.values())
                       - sum(captures.values())}
    check(runs["warm"]["captures"] == 0,
          f"{label}: the warm replay captured {runs['warm']['captures']}")
    warm = runs["warm"]
    probes = [expected_kernel_calls(cos.engine_for(*key)) for key in
              {(r.batch.workload, r.batch.d_bucket) for r in results}]
    check(warm["launches"] == {
        "limb_matmul": sum(r.stats["n_passes"] * r.stats["n_channels"]
                           for r in results) + sum(p[0] for p in probes),
        "mont_fold": sum(r.stats["n_folds"] for r in results)
        + sum(p[1] for p in probes)},
          f"{label}: warm launches {warm['launches']} != fold-profile totals "
          f"with one validation probe per class")
    per_workload = {}
    for r in results:
        per_workload[r.batch.workload] = (per_workload.get(r.batch.workload, 0)
                                          + r.batch.n_c)
    check(set(per_workload) == {"dilithium", "bn254"},
          f"{label}: trace did not reach both workloads")
    out = {"phase": "slice", "label": label, "requests": n_ops,
           "per_workload": per_workload, **runs["cold"],
           "dispatches": len(results), "fused_ntt_tile_launches": K3.launches,
           "launches_per_dispatch": {k: v / len(results)
                                     for k, v in warm["launches"].items()},
           "warm": warm, "programs": _program_census(cos, label),
           **cos.program_stats(), "rows_checked": 2 * len(cpu_rows),
           "device_memory": {
               "allocated_bytes": torch.cuda.memory_allocated(dev),
               "reserved_bytes": torch.cuda.memory_reserved(dev)}}
    emit(out)
    return out, cpu_rows


def _cpu_rows(d_uniform=None, **cos_kw) -> dict:
    """Every tenant row of the replay on the CPU (the plain versions)."""
    results, _, _ = _replay(SliceCoScheduler(device="cpu", **cos_kw),
                            d_uniform=d_uniform)
    rows = {}
    for r in results:
        rows.update(r.outputs)
    return rows


# The scopes of repro_torch.core.zones (and the engines' other scope names):
# profiler ranges that also show on the device as annotations spanning their
# kernels, which are not kernels.
SCOPE_RE = re.compile(r"^(wzone_|pzone_|tzone_|channel_\d|staging_pass_\d|"
                      r"lazy_window_\d|mxu_pointwise$|vpu_)")


def _kernel_events(prof):
    """The profiler's device-side kernel (and copy) averages, without the
    scopes' annotations."""
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not SCOPE_RE.match(ev.key)):
            yield ev


@contextlib.contextmanager
def _host_timers(spent: dict):
    """Add the host seconds spent in each program's H2D copy
    (``E2EProgram.load``), graph replay (``replay``) and D2H copy
    (``copy_out``) to ``spent``, and count the calls, by wrapping the
    methods; restored on exit.  All three are asynchronous, so this is the
    time to enqueue them (and to wait when the queue is full).  ``wait`` is
    the time ``gather`` spends in the CUDA events that mark results on the
    host, waiting for the device."""
    names = {"load": "h2d", "replay": "replay", "copy_out": "d2h"}
    originals = {name: getattr(E2EProgram, name) for name in names}
    event_sync = torch.cuda.Event.synchronize

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
                spent["calls"][key] += 1
        return wrapper

    for name, key in names.items():
        setattr(E2EProgram, name, timed(originals[name], key))
    torch.cuda.Event.synchronize = timed(event_sync, "wait")
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(E2EProgram, name, fn)
        torch.cuda.Event.synchronize = event_sync


def _profiled_replay(cos, dev, tries=3) -> tuple:
    """One warm replay under torch.profiler with the counters at 0: the
    profile, its wall time, and the census by profiler (K1/K2 kernel events
    equal to the counters' launches).  The profiler now and then drops
    events; a replay whose events fall short is profiled again, up to
    ``tries`` in all, and the last mismatch raises."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        _reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _replay(cos)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        events = {name: sum(ev.count for ev in _kernel_events(prof)
                            if f"{name}_kernel" in ev.key)
                  for name in ("limb_matmul", "mont_fold")}
        counted = {"limb_matmul": K1.launches, "mont_fold": K2.launches}
        if events == counted:
            return prof, wall, {"events": events, "counters": counted,
                                "tries": attempt + 1}
    raise AssertionError(f"profiler census: K1/K2 kernel events {events} != "
                         f"launches counted {counted}")


def phase_profile(dev):
    """Where the paper trace's wall time goes once every program is
    captured.  After a warm-up replay (which captures them), one replay
    with host timers around the programs' H2D copies, replays and D2H
    copies and the waits on their events splits the wall time on the host; one more under torch.profiler
    gives the device time of every kernel and checks the launch census a
    second way, by the K1/K2 kernel events.  The device idle share sets the
    profiled busy time against the unprofiled wall time (the profiler slows
    the host, not the kernels)."""
    cos = SliceCoScheduler(device=dev)
    _replay(cos)
    torch.cuda.synchronize(dev)
    captures = dict(cos.trace_counts)
    spent = {"h2d": 0.0, "replay": 0.0, "d2h": 0.0, "wait": 0.0,
             "calls": {"h2d": 0, "replay": 0, "d2h": 0, "wait": 0}}
    with _host_timers(spent):
        results, _, wall = _replay(cos)
        torch.cuda.synchronize(dev)
    check(cos.trace_counts == captures, "the warm replay captured a program")
    prof, wall_profiled, census = _profiled_replay(cos, dev)
    device = {"limb_matmul": 0.0, "mont_fold": 0.0}
    busy_us, n_kernels, top = 0.0, 0, []
    for ev in _kernel_events(prof):
        busy_us += ev.self_device_time_total
        n_kernels += ev.count
        top.append((ev.self_device_time_total / 1e6, ev.count, ev.key[:80]))
        for name in device:
            if f"{name}_kernel" in ev.key:
                device[name] += ev.self_device_time_total / 1e6
    top.sort(reverse=True)
    n_bn = sum(r.batch.workload == "bn254" for r in results)
    calls = spent.pop("calls")
    host = sum(spent.values())
    out = {"phase": "profile", "label": "paper", "wall_s": wall,
           "dispatches": len(results), "bn254_dispatches": n_bn,
           "host_s": spent,
           "host_share": {k: v / wall for k, v in spent.items()},
           "host_us_per_call": {k: spent[k] / calls[k] * 1e6 if calls[k]
                                else None for k in spent},
           "other_host_s": wall - host,
           "census_by_profiler": census,
           "device_s": device if busy_us else None,
           "device_busy_s": busy_us / 1e6 if busy_us else None,
           "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us else None,
           "device_kernels": n_kernels, "wall_profiled_s": wall_profiled,
           "top_device": [{"s": t, "count": c, "kernel": k}
                          for t, c, k in top[:8]],
           "program_vs_eager": _program_vs_eager(cos, dev)}
    emit(out)
    return out


def _kernels_per_call(fn, dev) -> int:
    """Device events (kernels and copies) of one call of ``fn``
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    return sum(ev.count for ev in _kernel_events(prof))


def _program_vs_eager(cos, dev) -> list:
    """One BN254 (d = 64) and one Dilithium (d = 256, two passes) dispatch
    of 8 rows: the program's run (the H2D copy and one graph replay)
    against the same ``eng.e2e`` called op by op on the program's static
    input, timed in turns (CUDA events, median of 20 runs of 5 calls), the
    outputs equal, with the device events each makes per call."""
    rng = np.random.default_rng(SEED + 2)
    rows = []
    for workload, d in (("bn254", 64), ("dilithium", 256)):
        shape = cos.operand_shape(workload, d, 8)
        prog = cos.program_for(workload, d, shape)
        eng = prog.eng
        if workload == "bn254":
            live = (rng.integers(0, 2**31, shape, dtype=np.uint64)
                    % np.array(eng.chain.moduli, np.uint64)).astype(np.uint32)
        else:
            live = rng.integers(0, Q, shape, dtype=np.uint64).astype(np.uint32)
        host, view = host_operand(shape, dev)
        view[:] = live
        got = prog.run(host).clone()

        def eager():
            return eng.e2e(prog.static_in, planes=prog.planes)

        check(torch.equal(got, eager().to(torch.int32)),
              f"{workload} d={d}: the program's output differs from the "
              f"op-by-op e2e")
        ms = median_ms_turns({"program": lambda: prog.run(host),
                              "eager": eager}, dev, runs=20, per_run=5)
        rows.append({"workload": workload, "d": d, "shape": list(shape),
                     "program_ms": ms["program"], "eager_ms": ms["eager"],
                     "eager_over_program": ms["eager"] / ms["program"],
                     "events_per_call": {
                         "program": _kernels_per_call(lambda: prog.run(host), dev),
                         "eager": _kernels_per_call(eager, dev)},
                     "capture_s": prog.capture_s, "equal": True})
    return rows


def _percentiles(xs) -> dict:
    xs = np.asarray(xs, np.float64)
    if not len(xs):
        return {}
    return {f"p{q}_s": float(np.percentile(xs, q)) for q in (50, 95, 99)}


def _cos_config(kw: dict) -> ServeConfig:
    """The co-scheduler's part of a run's server config."""
    keys = ("accum", "d_tile", "reduction_by_workload", "row_ladder_max")
    return ServeConfig(**{k: v for k, v in kw.items() if k in keys})


def _online_run(dev, cos, label: str, kw: dict, d_uniform,
                paths: dict | None):
    """One ``serve_crypto_online`` run of the paper trace on the card on
    ``cos`` (each program run counted per class), with the kernel counters
    at 0 and peak memory reset just before it.  Returns the run, its
    counts and the census it was held to."""
    runs = {}
    run = cos._run

    def counted(workload, d, operand):
        runs[(workload, d)] = runs.get((workload, d), 0) + 1
        return run(workload, d, operand)

    cos._run = counted
    captures = dict(cos.trace_counts)
    torch.cuda.synchronize(dev)
    # hand back what earlier phases left cached, so that the reserved peak
    # is this run's; the peak still counts from what they left allocated
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    reserved = torch.cuda.memory_reserved(dev)
    _reset_counters()
    try:
        load, snap, wall = serve_crypto_online(
            duration_s=0.25, rate_hz=4096, n_c=8, seed=SEED,
            d_uniform=d_uniform, validate=True, coscheduler=cos, device=dev,
            trace_out=paths and str(paths["trace"]),
            metrics_out=paths and str(paths["metrics"]), **kw)
        torch.cuda.synchronize(dev)
    finally:
        del cos._run
    memory = {"resident_before_bytes": resident,
              "reserved_before_bytes": reserved,
              "max_allocated_bytes": torch.cuda.max_memory_allocated(dev),
              "max_reserved_bytes": torch.cuda.max_memory_reserved(dev)}
    launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches,
                "fused_ntt_tile": K3.launches}
    # every dispatched class ran one validation probe besides its launches
    want = _census(cos, runs, captures, probes=1)
    check(launches == {**want, "fused_ntt_tile": 0} and all(want.values()),
          f"{label}: launches {launches} != the census {want} (and no K3)")
    check(sum(runs.values()) == snap["dispatch"]["dispatches"],
          f"{label}: {sum(runs.values())} launches counted, the telemetry "
          f"has {snap['dispatch']['dispatches']}")
    new = sum(cos.trace_counts.values()) - sum(captures.values())
    return load, snap, wall, memory, launches, want, new


def _check_online_rows(label: str, load, ref: dict, oracle: dict) -> int:
    """Every served tenant row against the reference replay's, Dilithium
    also against the int64 oracle; raises on the first mismatch."""
    by_d = {}
    for h in load.handles:
        if h.rejected:
            continue
        tid, row = h.request.tenant_id, h.result()
        check(np.array_equal(row, ref[tid]),
              f"{label}: tenant {tid} differs from the slice replay")
        if h.request.workload == "dilithium":
            by_d.setdefault(len(row), []).append(h)
    for d, hs in by_d.items():
        a = np.zeros((len(hs), d), np.uint32)
        for i, h in enumerate(hs):
            a[i, :h.request.degree] = h.request.coeffs
        if d not in oracle:
            oracle[d] = NTT.ntt_matrix(
                d, Q, negacyclic=(Q - 1) % (2 * d) == 0).astype(np.int64)
        want = ((a.astype(np.int64) @ oracle[d]) % Q).astype(np.uint32)
        got = np.stack([h.result() for h in hs])
        check(np.array_equal(got, want),
              f"{label}: dilithium d={d} rows differ from the oracle")
    return sum(len(hs) for hs in by_d.values())


def _idle_share(dev, coses: list, wall: float, run) -> dict:
    """``run()``, a warm run once more on ``coses``, under torch.profiler:
    the device's busy time over the unprofiled warm run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    captures = [dict(cos.trace_counts) for cos in coses]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    check([cos.trace_counts for cos in coses] == captures,
          "the profiled run captured a program")
    busy = sum(ev.self_device_time_total for ev in _kernel_events(prof)) / 1e6
    if not busy:
        return {"device_busy_s": None, "device_idle_share": None}
    return {"device_busy_s": busy, "device_idle_share": 1 - busy / wall}


def _online_summary(label: str, run: tuple, ref: dict, oracle: dict) -> dict:
    """The checks and the figures of one ``_online_run``."""
    load, snap, wall, memory, launches, want, captures = run
    served = sum(h.done() and not h.rejected for h in load.handles)
    dropped = len(load.handles) - served - len(load.rejected)
    check(dropped == 0 and served == snap["requests_served"] > 0,
          f"{label}: {dropped} requests neither served nor rejected")
    dil_rows = _check_online_rows(label, load, ref, oracle)
    by_workload = {}
    for h in load.handles:
        if not h.rejected:
            by_workload.setdefault(h.request.workload, []).append(h.latency_s)
    disp = snap["dispatch"]
    out = {"served": served, "rejected": len(load.rejected),
           "dropped": dropped, "rows_checked": served,
           "dilithium_oracle_rows": dil_rows, "wrong_rows": 0,
           "wall_s": wall, "ops_per_s": served / wall,
           "launches": launches, "census_launches": want,
           "census": "passed", "captures": captures,
           "latency": {k: snap["latency"][k]
                       for k in ("p50_s", "p95_s", "p99_s", "mean_s",
                                 "max_s")},
           "queue_wait": {k: snap["queue_wait"][k]
                          for k in ("p50_s", "p95_s", "p99_s")},
           "latency_by_workload": {w: _percentiles(v)
                                   for w, v in by_workload.items()},
           "k_occupancy_mean": snap["k_occupancy_mean"],
           "m_occupancy_mean": snap["m_occupancy_mean"],
           "batches": snap["batches"],
           "close_reasons": snap["close_reasons"],
           "reduction_stalls": {k: snap["reduction_stalls"][k] for k in
                                ("eager_folds", "deferred_folds")},
           "dispatch": {"launches": disp["dispatches"],
                        "merged": disp["merged_dispatches"],
                        "m_fill_mean": disp["m_fill_mean"],
                        "m_occupancy_mean": disp["m_occupancy_mean"]},
           "service_s_total": snap["service_s_total"],
           "device_memory": memory}
    if "controller" in snap:
        out["controller_updates"] = snap["controller"]["updates"]
        out["holdback"] = snap["holdback"]
    return out


def _memory_in_use(dev) -> dict:
    """Device memory in use once everything unreferenced is collected and
    the allocator's cache handed back: the allocator's allocated and
    reserved bytes, the card's used bytes (``cudaMemGetInfo``, which also
    sees what the allocator does not, such as graph executables), and the
    programs still alive."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    return {"allocated_bytes": torch.cuda.memory_allocated(dev),
            "reserved_bytes": torch.cuda.memory_reserved(dev),
            "used_bytes": total - free,
            "live_programs": sum(isinstance(o, E2EProgram)
                                 for o in gc.get_objects())}


def phase_online(dev, env: dict, refs: dict):
    """The online server on the card in the three configurations of
    ``ONLINE``, each run twice on one co-scheduler: cold (its programs
    captured at their first launch) and warm (none captured), each checked
    row by row and launch by launch.  The device memory in use before the
    phase and after it, with its co-schedulers dropped, shows what the
    phase left behind."""
    OUT.mkdir(exist_ok=True)
    oracle, outs = {}, []
    before = _memory_in_use(dev)
    for label, (kw, d_uniform, ref) in ONLINE.items():
        paths = None
        if label == "online_paper":
            paths = {"trace": OUT / "online_paper_trace.json.gz",
                     "metrics": OUT / "online_paper_metrics.om"}
        cos = coscheduler_from_config(_cos_config(kw), device=dev)
        cold = _online_summary(label, _online_run(
            dev, cos, label, kw, d_uniform, paths), refs[ref], oracle)
        warm = _online_summary(f"{label} warm", _online_run(
            dev, cos, f"{label} warm", kw, d_uniform, None), refs[ref], oracle)
        check(warm["captures"] == 0, f"{label}: the warm run captured "
              f"{warm['captures']} programs")
        out = {"phase": "online", "label": label,
               "nvidia_smi": env["nvidia_smi"], "config": kw,
               "d_uniform": d_uniform, **cold, "warm": warm,
               "programs": _program_census(cos, label),
               **cos.program_stats()}
        if paths:
            stats = validate_chrome_trace(str(paths["trace"]))
            check(stats["requests"] == cold["served"],
                  f"{label}: the trace has {stats['requests']} request "
                  f"chains for {cold['served']} served")
            mstats = validate_openmetrics(str(paths["metrics"]))
            out["trace"] = {"path": str(paths["trace"].relative_to(
                OUT.parent)), **stats}
            out["metrics"] = {"path": str(paths["metrics"].relative_to(
                OUT.parent)), **mstats}
            out.update(_idle_share(dev, [cos], warm["wall_s"], lambda: (
                serve_crypto_online(duration_s=0.25, rate_hz=4096, n_c=8,
                                    seed=SEED, validate=True, coscheduler=cos,
                                    device=dev, **kw))))
        emit(out)
        outs.append(out)
    del cos
    emit({"phase": "online_memory", "before": before,
          "after": _memory_in_use(dev)})
    return outs


def _cluster_coses(dev, kw: dict) -> list:
    """Fresh per-host co-schedulers, built as ``ClusterServer`` builds them:
    from the run's config, on ``dev`` or, under ``device_parallel``, on each
    host's slice of its devices."""
    cfg = _cos_config(kw)
    parts = (partition_devices(kw["hosts"], devices=dev)
             if kw.get("device_parallel") else None)
    return [coscheduler_from_config(cfg, host=h,
                                    device=parts[h] if parts else dev)
            for h in range(kw["hosts"])]


def _capture_s(cos) -> float:
    return cos.program_stats()["capture_s"]


def _cluster_run(dev, coses: list, label: str, kw: dict,
                 paths: dict | None) -> dict:
    """One ``serve_crypto_cluster`` run of the paper trace on the card, each
    host on its co-scheduler of ``coses`` (each program run counted per
    host and class), with the kernel counters at 0 and peak memory reset
    just before it; returns the run and its counts, checked against the
    census summed over the hosts."""
    runs = [{} for _ in coses]

    def counting(cos, counts):
        run = cos._run

        def counted(workload, d, operand):
            counts[(workload, d)] = counts.get((workload, d), 0) + 1
            return run(workload, d, operand)
        return counted

    # each host's validation probes: the host seconds of every first
    # validation of a class (CryptoServer._validate_once, the graph probe,
    # its reading and the checks), keyed by the host's co-scheduler
    spent = [[] for _ in coses]
    host_of = {id(cos): h for h, cos in enumerate(coses)}
    validate_once = CryptoServer._validate_once

    def timed_validation(server, batch):
        new = (batch.workload, batch.d_bucket) not in server._validated
        t0 = time.perf_counter()
        try:
            return validate_once(server, batch)
        finally:
            if new:
                spent[host_of[id(server.cos)]].append(
                    time.perf_counter() - t0)

    for cos, counts in zip(coses, runs):
        cos._run = counting(cos, counts)
    CryptoServer._validate_once = timed_validation
    captures = [dict(cos.trace_counts) for cos in coses]
    capture_s = [_capture_s(cos) for cos in coses]
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    _reset_counters()
    try:
        load, snap, wall = serve_crypto_cluster(
            duration_s=0.25, rate_hz=4096, n_c=8, seed=SEED, validate=True,
            device=dev, coscheduler_factory=lambda h: coses[h],
            trace_out=paths and str(paths["trace"]),
            metrics_out=paths and str(paths["metrics"]), **kw)
        torch.cuda.synchronize(dev)
    finally:
        CryptoServer._validate_once = validate_once
        for cos in coses:
            del cos._run
    launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches,
                "fused_ntt_tile": K3.launches}
    # every class a host dispatched ran one validation probe on that host
    want = {"limb_matmul": 0, "mont_fold": 0}
    for cos, counts, before in zip(coses, runs, captures):
        for k, v in _census(cos, counts, before, probes=1).items():
            want[k] += v
    check(launches == {**want, "fused_ntt_tile": 0} and all(want.values()),
          f"{label}: launches {launches} != the census summed over the "
          f"hosts {want} (and no K3)")
    per_host = [s["dispatch"]["dispatches"] for s in snap["per_host"]]
    check([sum(c.values()) for c in runs] == per_host,
          f"{label}: program runs per host {[sum(c.values()) for c in runs]}"
          f" != the telemetry's dispatches {per_host}")
    new = [sum(c.trace_counts.values()) - sum(b.values())
           for c, b in zip(coses, captures)]
    new_s = [_capture_s(c) - s0 for c, s0 in zip(coses, capture_s)]
    probes = [len(t) for t in spent]
    check(probes == [len(c) for c in runs],
          f"{label}: validation probes per host {probes}, classes "
          f"dispatched {[len(c) for c in runs]}")
    return {"load": load, "snap": snap, "wall": wall,
            "launches": launches, "want": want,
            "captures": new, "capture_s": new_s,
            # validation probes: the captures outside the program cache,
            # each with its graph read and checked
            "probes": probes,
            "probe_s": [sum(t) for t in spent],
            "memory": {"resident_before_bytes": resident,
                       "max_allocated_bytes":
                           torch.cuda.max_memory_allocated(dev),
                       "max_reserved_bytes":
                           torch.cuda.max_memory_reserved(dev)}}


def _cluster_summary(label: str, run: dict, ref: dict, oracle: dict) -> dict:
    """The checks and the figures of one ``_cluster_run``."""
    load, snap = run["load"], run["snap"]
    m = snap["merged"]
    served = sum(h.done() and not h.rejected for h in load.handles)
    dropped = len(load.handles) - served - len(load.rejected)
    check(dropped == 0 and served == m["requests_served"] > 0,
          f"{label}: {dropped} requests neither served nor rejected")
    dil_rows = _check_online_rows(label, load, ref, oracle)
    bar, gossip, fo = snap["drain_barrier"], snap["gossip"], snap["failover"]
    check(bar["complete"] and bar["inflight_groups"] == 0,
          f"{label}: drain barrier {bar}")
    check(gossip["used_staleness_max_s"] <= gossip["staleness_bound_s"],
          f"{label}: gossip used a digest {gossip['used_staleness_max_s']} s "
          f"old, past its bound {gossip['staleness_bound_s']} s")
    check(fo["lost"] == 0 and fo["limbo_pending"] == 0,
          f"{label}: {fo['lost']} requests lost, {fo['limbo_pending']} in "
          f"limbo")
    by_workload = {}
    for h in load.handles:
        if not h.rejected:
            by_workload.setdefault(h.request.workload, []).append(h.latency_s)
    return {"served": served, "rejected": len(load.rejected),
            "dropped": dropped, "rows_checked": served,
            "dilithium_oracle_rows": dil_rows, "wrong_rows": 0,
            "wall_s": run["wall"], "ops_per_s": served / run["wall"],
            "launches": run["launches"], "census_launches": run["want"],
            "census": "passed",
            "per_host_requests": m["load_imbalance"]["per_host_requests"],
            "load_imbalance": {k: m["load_imbalance"][k]
                               for k in ("max_over_mean", "cv")},
            "per_host_dispatches": [s["dispatch"]["dispatches"]
                                    for s in snap["per_host"]],
            "latency": {k: m["latency"][k]
                        for k in ("p50_s", "p95_s", "p99_s", "mean_s",
                                  "max_s", "merged_exact")},
            "latency_by_workload": {w: _percentiles(v)
                                    for w, v in by_workload.items()},
            "batches": m["batches"], "close_reasons": m["close_reasons"],
            "dispatch": {"launches": m["dispatch"]["dispatches"],
                         "merged": m["dispatch"]["merged_dispatches"]},
            "captures_per_host": run["captures"],
            "capture_s_per_host": run["capture_s"],
            "probes_per_host": run["probes"],
            "probe_s_per_host": run["probe_s"],
            "gossip": {k: gossip[k] for k in
                       ("publishes", "views", "stale_drops",
                        "used_staleness_max_s", "staleness_bound_s")},
            "drain_barrier": bar,
            "failover": {k: fo[k] for k in
                         ("replayed", "recovered", "deduped",
                          "limbo_delivered", "sheds", "lost")}
                        | {"cordons": fo["summary"]["cordons"],
                           "kills": fo["summary"]["kills"],
                           "recovers": fo["summary"]["recovers"]},
            "device_memory": run["memory"]}


def _cluster_rescue(dev) -> dict:
    """The gather-ring rescue on the card: two hosts built by
    ``ClusterServer`` itself, n_c = 1, async pipeline with a depth-2 ring;
    host 1 launches four Dilithium d = 64 groups and is killed with the
    newest two still in flight, and the silence-driven cordon must gather
    both (each host buffer after its CUDA event), resolve their handles
    with the int64 oracle's rows and replay nothing."""
    cluster = ClusterServer(ClusterConfig(
        n_hosts=2, fault_plan="kill@0.0005:h1", device=dev,
        serve=ServeConfig(n_c=1, max_age_s=10.0, validate=False,
                          async_pipeline=True, inflight_depth=2)))
    rng = np.random.default_rng(SEED + 18)
    handles, tid = [], 0
    for i in range(4):
        while cluster.router.host_for(tid) != 1:
            tid += 1
        coeffs = rng.integers(0, Q, 64, dtype=np.int64).astype(np.uint32)
        handles.append(cluster.submit(
            TenantRequest(tid, "dilithium", 64, 1e-4 * i, coeffs),
            now=1e-4 * i))
        tid += 1
    in_flight = cluster.hosts[1].inflight_groups
    pending = sum(not h.done() for h in handles)
    check(in_flight == 2 and pending == 2,
          f"rescue: {in_flight} groups in flight, {pending} handles pending")
    cluster.pump(0.006)                  # kill applied, silence → cordon
    fo = cluster.failover
    check(fo.recovered == 2 and fo.replayed == 0 and fo.lost() == 0
          and cluster.hosts[1].inflight_groups == 0,
          f"rescue: recovered {fo.recovered}, replayed {fo.replayed}, "
          f"lost {fo.lost()}")
    oracle = NTT.ntt_matrix(64, Q, negacyclic=True).astype(np.int64)
    for h in handles:
        want = ((h.request.coeffs.astype(np.int64) @ oracle) % Q)
        check(h.done() and not h.rejected
              and np.array_equal(h.result(), want.astype(np.uint32)),
              f"rescue: tenant {h.request.tenant_id} differs from the oracle")
    cluster.drain(0.01)
    return {"recovered": fo.recovered, "replayed": fo.replayed,
            "lost": fo.lost(), "rows_checked": len(handles),
            "device_ids": [e["device_ids"] for e in fo.events
                           if e["kind"] == "cordon"]}


def phase_cluster(dev, env: dict, ref: dict):
    """The cluster on the card in the three configurations of ``CLUSTER``,
    each run cold (fresh per-host co-schedulers) and warm (the same
    co-schedulers again), each checked row by row against the slice replay
    and launch by launch against the census summed over its hosts; (b)'s
    and (c)'s rows also against (a)'s."""
    OUT.mkdir(exist_ok=True)
    oracle, outs, paper = {}, [], None
    for label, kw in CLUSTER.items():
        paths = None
        if label == "cluster_paper":
            paths = {"trace": OUT / "cluster_paper_trace.json.gz",
                     "metrics": OUT / "cluster_paper_metrics.om"}
        coses = _cluster_coses(dev, kw)
        cold_run = _cluster_run(dev, coses, label, kw, paths)
        cold = _cluster_summary(label, cold_run, ref, oracle)
        warm_run = _cluster_run(dev, coses, f"{label} warm", kw, None)
        warm = _cluster_summary(f"{label} warm", warm_run, ref, oracle)
        check(not any(warm["captures_per_host"]),
              f"{label}: the warm run captured {warm['captures_per_host']}")
        for run in (cold_run, warm_run):
            outputs = run["load"].outputs
            if paper is None:
                paper = outputs
            check(outputs.keys() == paper.keys() and all(
                np.array_equal(row, paper[tid])
                for tid, row in outputs.items()),
                f"{label}: rows differ from cluster_paper's")
        snap = cold_run["snap"]
        out = {"phase": "cluster", "label": label,
               "nvidia_smi": env["nvidia_smi"],
               "config": {k: v for k, v in kw.items()}, **cold,
               "warm": warm,
               "programs": sum(_program_census(c, f"{label} h{h}")
                               for h, c in enumerate(coses)),
               "pool_bytes": coses[0].program_stats()["pool_bytes"],
               "devices": snap["devices"]}
        if kw.get("device_parallel"):
            out["dispatch_overlap"] = snap["dispatch_overlap"]
        if kw.get("fault_plan"):
            out["rescue"] = _cluster_rescue(dev)
            check(cold["failover"]["kills"] == 1
                  and cold["failover"]["recovers"] == 1
                  and cold["failover"]["cordons"] >= 1,
                  f"{label}: the fault plan did not run: {cold['failover']}")
        if paths:
            stats = validate_chrome_trace(str(paths["trace"]))
            check(stats["requests"] == cold["served"],
                  f"{label}: the trace has {stats['requests']} request "
                  f"chains for {cold['served']} served")
            out["trace"] = {"path": str(paths["trace"].relative_to(
                OUT.parent)), **stats}
            out["metrics"] = {"path": str(paths["metrics"].relative_to(
                OUT.parent)),
                **validate_openmetrics(str(paths["metrics"]))}
            out.update(_idle_share(dev, coses, warm["wall_s"], lambda: (
                serve_crypto_cluster(duration_s=0.25, rate_hz=4096, n_c=8,
                                     seed=SEED, validate=True, device=dev,
                                     coscheduler_factory=lambda h: coses[h],
                                     **kw))))
        emit(out)
        outs.append(out)
    return outs


def _classes(d_uniform=None) -> list:
    """The (workload, d_bucket) classes of the replay's trace, in the order
    ``serve_crypto`` first dispatches them (its batching without the
    dispatch)."""
    trace = PoissonTrace(rate_hz=4096, duration_s=0.25,
                         uniform_degree=d_uniform, seed=SEED).generate()
    attach_payloads(trace, seed=SEED)
    q = IngressQueue()
    q.push_trace(trace)
    sched = RectangularScheduler(n_c=8)
    keys = []
    while q.workloads:
        for w in list(q.workloads):
            for batch in sched.plan_batches(q.pop_batch(w, 8)):
                if (w, batch.d_bucket) not in keys:
                    keys.append((w, batch.d_bucket))
    return keys


def _profiled_counts(fn, dev) -> dict:
    """K1/K2/K3 kernel events of one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    return {name: sum(ev.count for ev in _kernel_events(prof)
                      if f"{name}_kernel" in ev.key)
            for name in ("limb_matmul", "mont_fold", "fused_ntt_tile")}


def _validator_class(dev, cos, cpu_cos, workload: str, d: int,
                     rng) -> dict:
    """One class at the replay's height: the host seconds of the census
    probe that came before the validator (a plain capture, its recorded
    calls against the fold profile) and of the server's probe now
    (``validate_fn``: a capture with the graph kept, the launch log, the
    graph reader and the checks), taken in turns (census, validator,
    validator, census); then the server's probe kept (a ``GraphProbe``
    checked by ``validate_probe``, as ``validate_fn`` checks it), its K1/K2
    nodes held against the census, its capture's recorded calls and the
    profiler's kernel events of one replay of the validated graph, and that
    replay's rows against the CPU engine on the same operand; the graph
    pool's bytes before the probe and after it is dropped."""
    eng = cos.engine_for(workload, d)
    shape = cos.operand_shape(workload, d, 8)
    expect = V.checks_for(eng, cos.reduction_for(workload))
    zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
    planes = cos.device_planes_for(workload, d)

    def census_probe():
        # the probe before the validator: a plain capture, its recorded
        # calls held against the fold profile
        prog = cos.capture(workload, d, shape)
        check_launch_census(eng, prog.calls["limb_matmul"],
                            prog.calls["mont_fold"], f"{workload}/d{d}")

    def validator_probe():
        # the server's probe now: validate_fn on the e2e, the census
        rep = V.validate_fn(lambda x, pl: eng.e2e(x, planes=pl), zeros,
                            planes, **expect)
        check_launch_census(eng, rep.n_dots, rep.n_folds, f"{workload}/d{d}")
        rep.raise_if_failed()

    probe_s = {"census_capture": [], "validate_fn": []}
    for name, fn in (("census_capture", census_probe),
                     ("validate_fn", validator_probe),
                     ("validate_fn", validator_probe),
                     ("census_capture", census_probe)):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        probe_s[name].append(time.perf_counter() - t0)
        gc.collect()
    pool_before = capture_pool(dev).bytes()
    operand = torch.zeros(shape, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    probe = GraphProbe(lambda: eng.e2e(operand, planes=planes), dev)
    probe_capture_s = time.perf_counter() - t0
    rep = V.validate_probe(probe, **expect)
    check(rep.ok, f"validator {workload}/d{d}: {rep.violations} "
          f"(graph {rep.graph})")
    k1, k2 = expected_kernel_calls(eng)
    nodes = rep.graph["kernel_nodes"]
    check((rep.n_dots, rep.n_folds) == (k1, k2)
          == (nodes["limb_matmul"], nodes["mont_fold"])
          == (probe.calls["limb_matmul"], probe.calls["mont_fold"])
          and nodes["fused_ntt_tile"] == 0,
          f"validator {workload}/d{d}: nodes {nodes}, census {(k1, k2)}, "
          f"capture calls {probe.calls}")
    check(rep.graph["edges"]["programmatic"] > 0,
          f"validator {workload}/d{d}: the reader returned no programmatic "
          f"edge, though every K2 is a programmatic dependent")
    if workload == "bn254":
        live = (rng.integers(0, 2**31, shape, dtype=np.uint64)
                % np.array(eng.chain.moduli, np.uint64)).astype(np.uint32)
    else:
        live = rng.integers(0, Q, shape, dtype=np.uint64).astype(np.uint32)
    host, view = host_operand(shape, dev)
    view[:] = live
    operand.copy_(host)
    # The profiler now and then drops a window's kernel events (as in
    # _profiled_replay): a replay whose events differ from the nodes is
    # profiled again, up to three windows, and the last mismatch raises.
    want_events = {"limb_matmul": k1, "mont_fold": k2, "fused_ntt_tile": 0}
    for profile_tries in range(1, 4):
        events = _profiled_counts(probe.replay, dev)
        if events == want_events:
            break
    check(events == want_events,
          f"validator {workload}/d{d}: kernel events of one replay "
          f"{events} != the nodes {(k1, k2)} in {profile_tries} windows")
    got = probe.out.to(torch.int32).cpu()
    want = cpu_cos.engine_for(workload, d).e2e(
        torch.from_numpy(live.astype(np.int64))).to(torch.int32)
    check(torch.equal(got, want),
          f"validator {workload}/d{d}: the validated probe's rows differ "
          f"from the CPU engine's")
    out = {"class": f"{workload}/d{d}", "shape": list(shape),
           "ok": rep.ok, "n_barriers": rep.n_barriers,
           "zones": sorted(rep.zones | rep.precision_zones),
           "graph": rep.graph, "probe_capture_s": probe_capture_s,
           "read_s": probe.read_s, "probe_s": probe_s,
           "replay_events": events, "replay_profile_tries": profile_tries,
           "rows_equal": True,
           "pool_bytes_before": pool_before}
    del probe
    gc.collect()
    out["pool_bytes_after"] = capture_pool(dev).bytes()
    return out


def _malformed(dev) -> dict:
    """The four malformed programs of the validator's tests, built on the
    card, and the violation code each must be flagged with from its graph:
    a staged transform that runs every pass's GEMM before any fold (V1,
    V2), a lazy window that folds twice (V7), an eager program audited as
    lazy (V6), and a fold in one workload zone of a GEMM of another (V3)."""
    d_tile, m = 32, Q
    plan = G.make_channel_plan(
        NTT.ntt_matrix(96, Q, negacyclic=True), Q, data_limbs=3, tw_limbs=3)
    _, fused = G.plane_operands(plan, dev)
    la, n_diag = plan.data_limbs, plan.n_diag
    tiles = plan.tile_bounds(d_tile)
    zeros = torch.zeros((2, plan.d), dtype=torch.int32, device=dev)

    def zoned(fn, zone="dilithium"):
        def run(a):
            with Z.workload_zone(zone, dev), Z.precision_zone(3, dev):
                return fn(a)
        return run

    def deferred(a):
        diags = []
        for t, (lo, hi) in enumerate(tiles):
            with Z.scope(f"staging_pass_{t}", dev):
                diags.append(G.tile_diagonals(a[:, lo:hi], None,
                                              fused[lo * la:hi * la], plan))
        y = torch.zeros((a.shape[0], plan.d), dtype=torch.int64, device=dev)
        for t, diag in enumerate(diags):
            with Z.scope(f"staging_pass_{t}", dev), Z.scope("vpu_fold", dev):
                y = F.addmod(y, mont_fold(diag, m), m)
        return y

    def double_fold(a):
        diag = G.tile_diagonals(a, None, fused, plan)
        with Z.scope("lazy_window_0", dev), Z.scope("vpu_fold_lazy", dev):
            y1 = mont_fold(diag, m)
            y2 = mont_fold(diag + 1, m)
        return F.addmod(y1, y2, m)

    def eager(a):
        return G.staged_transform(a, plan, d_max=d_tile,
                                  planes=(None, fused))[0]

    def cross_zone(a):
        with Z.workload_zone("dilithium", dev), Z.precision_zone(3, dev):
            diag = G.tile_diagonals(a, None, fused, plan)
        with Z.workload_zone("bn254", dev), Z.precision_zone(3, dev):
            return mont_fold(diag, m)

    return {
        "deferred_fold": (zoned(deferred), dict(expected_passes=len(tiles)),
                          {"V1", "V2"}),
        "double_fold_window": (zoned(double_fold), dict(
            expect_eager=False, expected_windows=1, n_diag=n_diag), {"V7"}),
        "eager_fold_in_lazy": (zoned(eager), dict(
            expect_eager=False, expected_windows=1, n_diag=n_diag), {"V6"}),
        "cross_zone_combine": (cross_zone, dict(expect_eager=False),
                               {"V3"}),
    }, zeros


def _zoned_kernel_events(dev) -> dict:
    """One eager BN254 e2e (d = 64) under torch.profiler: every K1/K2 kernel
    event must be launched inside a ``wzone_*`` range, by the runtime call
    the trace correlates with it lying in such a range of its thread."""
    from torch.profiler import ProfilerActivity, profile
    eng = WK.make_engine("bn254", 64, device=str(dev))
    a = torch.zeros((8, 64, eng.n_channels), dtype=torch.int32, device=dev)
    eng.e2e(a)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.e2e(a)
        torch.cuda.synchronize(dev)
    OUT.mkdir(exist_ok=True)
    path = OUT / "validator_zones_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    zones = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("wzone_")]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    counts = {"limb_matmul": 0, "mont_fold": 0, "inside": 0, "unlinked": 0}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel" or not (
                "limb_matmul_kernel" in name or "mont_fold_kernel" in name):
            continue
        counts["limb_matmul" if "limb_matmul" in name else "mont_fold"] += 1
        rt = runtime.get(e.get("args", {}).get("correlation"))
        if rt is None:
            counts["unlinked"] += 1
        elif any(t == rt["tid"] and t0 <= rt["ts"] <= t1
                 for t, t0, t1 in zones):
            counts["inside"] += 1
    k1, k2 = expected_kernel_calls(eng)
    check(counts["limb_matmul"] == k1 and counts["mont_fold"] == k2
          and counts["inside"] == k1 + k2,
          f"zoned kernel events {counts}: every one of the {k1} K1 and {k2} "
          f"K2 events must be launched inside a wzone_* range")
    path.unlink()
    return counts


def phase_validator(dev) -> dict:
    """The structural validator on the card: every class of the paper and
    mixed eager/lazy replays validated from its probe's graph, node by
    node, and its validated probe replayed with its rows checked; the four
    malformed programs flagged from their graphs; one fused transform (K3)
    validated; one eager e2e's K1/K2 kernel events inside wzone_* ranges."""
    rng = np.random.default_rng(SEED + 5)
    out = {"phase": "validator", "classes": {}}
    for label, d_uniform, kw in (("paper", None, {}),
                                 ("mixed_eager_lazy", 256, MIXED)):
        cos = SliceCoScheduler(device=dev, **kw)
        cpu_cos = SliceCoScheduler(device="cpu", **kw)
        out["classes"][label] = [
            _validator_class(dev, cos, cpu_cos, w, d, rng)
            for w, d in _classes(d_uniform)]
    cases, zeros = _malformed(dev)
    out["malformed"] = {}
    for name, (fn, checks, codes) in cases.items():
        rep = V.validate_fn(fn, zeros, **checks)
        got = {v[0] for v in rep.violations}
        check(rep.graph is not None and not rep.ok and got == codes,
              f"validator: malformed {name} gave {sorted(got)} from "
              f"{'the graph' if rep.graph else 'the log'}, expected "
              f"{sorted(codes)}: {rep.violations}")
        out["malformed"][name] = {"codes": sorted(got),
                                  "nodes": rep.graph["kernel_nodes"],
                                  "edges": rep.graph["edges"]}
    plan = WK.make_engine("dilithium", 256, device=str(dev)).plan
    planes = G.plane_operands(plan, dev)
    a = torch.zeros((8, 256), dtype=torch.int32, device=dev)

    def fused(x):
        with Z.workload_zone("dilithium", dev), Z.precision_zone(3, dev):
            return fused_transform(x.to(torch.int64), plan, planes=planes)

    rep = V.validate_fn(fused, a)
    rep.raise_if_failed()
    nodes = rep.graph["kernel_nodes"]
    check(nodes["fused_ntt_tile"] == plan.n_passes and rep.n_dots == 0
          and rep.n_folds == 0,
          f"validator: fused transform nodes {nodes}, {plan.n_passes} passes")
    out["fused_transform"] = {"nodes": nodes, "zones": sorted(rep.zones),
                              "read_s": rep.graph["read_s"]}
    out["zoned_kernel_events"] = _zoned_kernel_events(dev)
    emit(out)
    return out


def phase_examples(dev, env: dict) -> dict:
    """Each crypto example of ``repro_torch.examples`` run by its ``main`` on
    the card, at its defaults, with the K1/K2/K3 counters set to 0 just
    before it and read just after: its summary (every check of the example
    raises on a failure), its launches, which must include K1 and K2, its
    wall seconds and what it printed."""
    import importlib
    import io
    out = {"phase": "examples", "device": str(dev),
           "nvidia_smi": env["nvidia_smi"], "examples": {}}
    for name in EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        printed = io.StringIO()
        _reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            summary = module.main(["--device", str(dev)])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches,
                    "fused_ntt_tile": K3.launches}
        check(summary["ok"] and summary["device"] == str(dev)
              and launches["limb_matmul"] > 0 and launches["mont_fold"] > 0,
              f"example {name}: {summary}, launches {launches}")
        out["examples"][name] = {"summary": summary, "launches": launches,
                                 "wall_s": wall,
                                 "printed": printed.getvalue().splitlines()}
    emit(out)
    return out


def phase_dryrun(dev, env: dict) -> dict:
    """The dry run's crypto cells (``repro_torch.launch.dryrun.run_cell``)
    on the card, each with the K1/K2/K3 counters set to 0 just before it:
    the step captured once as a graph (its warm-up under the op census),
    read, validated (V1–V7, no violation), priced node by node and
    replayed (once to instantiate, five times timed, twice or more under
    torch.profiler); every output exact (each channel against (a @ W) mod
    m, BN254's digits against the plain ``rns_to_field`` on the CPU); the
    K1/K2 nodes equal to the cell's fold profile, and the counters to the
    warm-up's calls plus the replays'.  Then the census check on this
    torch (``census_local``) and the LM cells (``lm_cells``): DRYRUN_LM_CELLS
    on both production meshes, each ``ok`` with collectives counted and
    bytes per device, planned on the host with the counters at 0, and
    DRYRUN_LM_SKIPPED ``skipped`` by JAX's rule."""
    out = {"phase": "dryrun", "nvidia_smi": env["nvidia_smi"], "cells": []}
    for arch, shape in DRYRUN_CELLS:
        _reset_counters()
        rec = DRY.run_cell(arch, shape, device=dev)
        torch.cuda.synchronize(dev)
        nodes = rec["kernel_nodes"]
        replays = rec["replays"]
        launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches}
        check(rec["status"] == "ok" and rec["exact"] and not rec["v_codes"]
              and launches == {k: nodes[k] * (1 + replays) for k in launches}
              and K3.launches == 0,
              f"dryrun {arch} {shape}: status {rec['status']}, V codes "
              f"{rec['v_codes']}, launches {launches} for nodes {nodes} and "
              f"{replays} replays")
        rec["launches"] = launches
        out["cells"].append(rec)
    out["mesh_cells"] = _dryrun_mesh_cells(dev)
    out["share_kernels"] = _share_kernels(dev, env["device"],
                                          out["mesh_cells"])
    out["census_local"] = _census_sees_local_shards()
    out["lm_cells"] = []
    for (arch, shape), multi in [(c, m) for c in DRYRUN_LM_CELLS
                                 + DRYRUN_LM_SKIPPED for m in (False, True)]:
        _reset_counters()
        rec = DRY.run_cell(arch, shape, multi_pod=multi)
        want = "skipped" if (arch, shape) in DRYRUN_LM_SKIPPED else "ok"
        check(rec["status"] == want and not any(_counts().values()),
              f"dryrun {arch} {shape} {rec['mesh']}: status "
              f"{rec['status']} ({rec.get('error') or rec.get('reason')}), "
              f"launches {_counts()}")
        if want == "ok":
            check(rec["collectives_naive"]["count"] > 0
                  and rec["bytes_per_device"] > 0
                  and rec["roofline"]["n_chips"] == (512 if multi else 256),
                  f"dryrun {arch} {shape} {rec['mesh']}: {rec['roofline']}")
        rec.pop("trace", None)
        out["lm_cells"].append(rec)
    emit(out)
    return out


def _dryrun_mesh_cells(dev) -> list:
    """DRYRUN_CELLS planned on both production meshes (``run_cell`` with
    ``multi_pod``: JAX's rows, the fake group, the sharded census), each
    with rank 0's block run on the card (the ``share``: captured,
    validated, priced, replayed under torch.profiler, exact).  The block is
    the same on both meshes, so the first mesh runs it and the second takes
    it; the counters are set to 0 before each mesh: the first's K1/K2
    launches must be the share's nodes × (1 + its replays), the second's 0
    (a plan launches nothing).  Each plan: ``ok``, no collective, its K1/K2
    calls a device equal to the share's nodes and the fold profile."""
    cells = []
    for arch, shape in DRYRUN_CELLS:
        share = None
        for multi in (False, True):
            _reset_counters()
            rec = DRY.run_cell(arch, shape, multi_pod=multi, device=dev,
                               share=share)
            torch.cuda.synchronize(dev)
            launches = _counts()
            what = f"dryrun {arch} {shape} {rec['mesh']}"
            check(rec["status"] == "ok", f"{what}: {rec.get('error')}")
            n_chips = 512 if multi else 256
            sh = rec["share"]
            nodes = {k: sh["kernel_nodes"][k] for k in ("limb_matmul",
                                                         "mont_fold")}
            check(rec["rows"] == DRY.CRYPTO_SHAPES[shape]["rows_per_core"]
                  * n_chips and rec["roofline"]["n_chips"] == n_chips
                  and rec["collectives_naive"]["count"] == 0
                  and sh["exact"] and not sh["v_codes"]
                  and nodes == rec["fold_profile"]["launches"]
                  == {k: rec["kernel_nodes"][k] for k in nodes},
                  f"{what}: rows {rec['rows']}, collectives "
                  f"{rec['collectives_naive']}, share nodes {nodes}, plan "
                  f"{rec['kernel_nodes']}, V codes {sh['v_codes']}")
            want = ({k: v * (1 + sh["replays"]) for k, v in nodes.items()}
                    if share is None else {k: 0 for k in nodes})
            check({k: launches[k] for k in nodes} == want
                  and launches["fused_ntt_tile"] == 0,
                  f"{what}: launches {launches}, expected {want}")
            rec["launches"] = launches
            rec.pop("trace", None)
            cells.append(rec if share is None else
                         dict(rec, share={"same_as": share["mesh"]}))
            share = sh
    return cells


def _share_shapes(rec) -> dict:
    """K1 and K2 shapes of a share and the launches of each in one run of
    its step: every staging tile (Dilithium 171 wide, BN254 128) is
    La·Lw K1 calls a channel, every pass one K2 call a channel."""
    sh, prof = rec["share"], rec["fold_profile"]
    limbs = DRY.LIMBS[rec["workload"]]
    channels = prof["n_channels"]
    step = G.staging_d_max(limbs, limbs, rec["accum"])
    widths = [min(step, rec["d"] - lo) for lo in range(0, rec["d"], step)]
    k1, k2 = collections.Counter(), collections.Counter()
    for k in widths:
        k1[(sh["rows"], k, sh["cols"])] += limbs * limbs * channels
        k2[(sh["rows"] * sh["cols"], prof["n_diag"])] += channels
    return {"limb_matmul": k1, "mont_fold": k2}


def _share_kernels(dev, card: str, mesh_cells: list) -> list:
    """K1 and K2 at the shapes of each cell's share (128 rows against d ÷
    16 output columns), each checked bit for bit against its plain version
    on the card, then timed (CUDA events, 20 calls a run, median of 20
    runs; K1 in turns with its plain version and ``torch.matmul`` in f32,
    TF32 off), its device time (torch.profiler), its bound as the share
    prices it (``graph_cost.node_cost``: an fp32_mantissa GEMM as FFMA;
    K1's int8 tensor-core bound beside it), its launches in one run of the
    share and the cell.  The launches here compare a
    kernel with its plain version and are not the main path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 27)
    rows = []
    for rec in mesh_cells:
        if "same_as" in rec["share"]:
            continue
        fp32 = rec["accum"] == "fp32_mantissa"
        modulus = DRY.moduli(rec["workload"])[0]
        for kernel, counts in _share_shapes(rec).items():
            for shape, launches in counts.items():
                row = {"cell": f"{rec['arch']} {rec['shape']}",
                       "kernel": kernel, "shape": list(shape),
                       "launches_per_share": launches}
                if kernel == "limb_matmul":
                    n, k, m = shape
                    a = torch.as_tensor(rng.integers(0, 256, (n, k),
                                                     dtype=np.uint8),
                                        device=dev)
                    b = torch.as_tensor(rng.integers(-128, 128, (k, m))
                                        .astype(np.int8), device=dev)
                    err = max_abs_err(limb_matmul_cuda(a, b, rec["accum"]),
                                      limb_matmul_ref(a, b, rec["accum"]))
                    bound, by = bound_ms(kernel, card, n=n, k=k, m=m,
                                         fp32=fp32)
                    row["int8_bound_ms"] = bound_ms(kernel, card, n=n, k=k,
                                                    m=m)[0]
                    call = (lambda a=a, b=b: limb_matmul_cuda(a, b,
                                                              rec["accum"]))
                    fns = {"kernel": call,
                           "plain": lambda a=a, b=b: limb_matmul_ref(
                               a, b, rec["accum"])}
                    a_f, b_f = a.float(), b.float()
                    fns["library"] = lambda a_f=a_f, b_f=b_f: torch.matmul(
                        a_f, b_f)
                    name = "limb_matmul_kernel"
                else:
                    n_out, nd = shape
                    diags = k2_inputs(rng, dev, (n_out, nd))
                    err = max_abs_err(mont_fold_cuda(diags, modulus),
                                      mont_fold_ref(diags, modulus))
                    bound, by = bound_ms(kernel, card, n_out=n_out,
                                         n_diag=nd)
                    call = (lambda diags=diags: mont_fold_cuda(diags,
                                                               modulus))
                    fns = {"kernel": call, "plain": lambda diags=diags:
                           mont_fold_ref(diags, modulus)}
                    name = "mont_fold_kernel"
                check(err == 0, f"share {kernel} {shape}: max |err| {err}")
                ms = median_ms_turns(fns, dev, runs=20)
                rows.append(dict(
                    row, max_abs_err=err, kernel_ms=ms["kernel"],
                    kernel_device_ms=device_ms(call, name, dev),
                    plain_ms=ms["plain"], library_ms=ms.get("library"),
                    library_device_ms=(device_ms(fns["library"], None, dev)
                                       if "library" in fns else None),
                    bound_ms=bound, bound_by=by,
                    blocks=(grid_blocks(shape[0], shape[2])
                            if kernel == "limb_matmul"
                            else k2_grid_blocks(shape[0]))))
    return rows


def _census_sees_local_shards() -> dict:
    """The sharded census on this torch: x (8, 64) batch-sharded over
    ``data`` times w (64, 64) column-sharded over ``model`` on a (4, 2)
    mesh is one local (2, 64) × (64, 32) product, whatever DTensor runs on
    the global shapes to learn the result's metadata."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.shardings import P
    mesh = MESH.make_mesh((4, 2), ("data", "model"), ["cpu"])
    with DRY.fake_world(mesh) as dmesh, FakeTensorMode():
        placer = DRY._Placer(mesh, dmesh)
        x = placer.tensor(torch.empty((8, 64), device="meta"),
                          P("data", None))
        w = placer.tensor(torch.empty((64, 64), device="meta"),
                          P(None, "model"))
        census = GC.ShardedOpCensus()
        with census:
            y = x @ w
        shape = tuple(y.to_local().shape)
    ops = [name for name, _ in census.ops]
    check(ops == ["aten.mm.default"] and shape == (2, 32),
          f"dryrun census: ops {ops}, local result {shape}")
    return {"ops": ops, "local_result": list(shape),
            "cost": census.ops[0][1]}


def _lm_close(got, want, tol: float, what: str) -> float:
    """max |got - want|, every element within tol + tol·|want|."""
    err = (got.float().cpu() - want.float().cpu()).abs()
    bound = tol + tol * want.float().cpu().abs()
    check(bool((err <= bound).all()),
          f"lm {what}: max |err| {float(err.max())}, tolerance {tol}")
    return float(err.max())


def _lm_rel(got, want, what: str) -> dict:
    """max |got - want| over max |want|, against LM_BF16_REL_TOL, and the
    share of positions whose greedy token agrees."""
    got, want = got.float(), want.float()
    rel = float((got - want).abs().max() / want.abs().max())
    check(rel <= LM_BF16_REL_TOL,
          f"lm {what}: relative error {rel} above {LM_BF16_REL_TOL}")
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_ref": float(want.abs().max()), "rel_err": rel,
            "tolerance": LM_BF16_REL_TOL,
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}


def _lm_step(cfg, model, prompts, tok=None, prompt_len=16):
    """Train-mode logits, prefill logits and the first decode step's logits
    of one batch, and the token decoded: the prefill's greedy token unless
    ``tok`` gives it."""
    with torch.no_grad():
        train, _, _ = model(prompts, mode="train")
    pre, cache = LMST.make_prefill(cfg, max_len=prompt_len + 8)(model, prompts)
    if tok is None:
        tok = torch.argmax(pre[:, -1], dim=-1).to(torch.int32)[:, None]
    _, dec, _ = LMST.make_decode_step(cfg)(model, cache, tok, prompt_len)
    return train, pre, dec, tok


def _lm_smoke(dev, arch: str) -> dict:
    """(a) and, for LM_DECODE_ARCHS, (b): one smoke arch drawn on the CPU
    from SEED and copied to the card."""
    cfg = smoke_config(arch)
    cpu_model = LM.LMModel(cfg, device="cpu", seed=SEED)
    card_model = copy.deepcopy(cpu_model).to(dev)
    tokens = {where: serve_lm(cfg, model=m, device=m.device)[0]
              for where, m in (("cpu", cpu_model), ("card", card_model))}
    check(np.array_equal(tokens["cpu"], tokens["card"]),
          f"lm {arch}: greedy tokens {tokens['card'].tolist()} on the card, "
          f"{tokens['cpu'].tolist()} on the CPU")
    runs = {where: _lm_step(cfg, m, lm_prompts(cfg, seed=SEED + 1,
                                               device=m.device))
            for where, m in (("cpu", cpu_model), ("card", card_model))}
    out = {"tokens": tokens["card"].tolist(), "max_abs_err": {
        name: _lm_close(runs["card"][i], runs["cpu"][i], LM_SMOKE_TOL,
                        f"{arch} {name} logits, card against CPU")
        for i, name in enumerate(("train", "prefill", "decode"))}}
    if arch in LM_DECODE_ARCHS:
        prompts = lm_prompts(cfg, seed=SEED + 1, device=dev)
        _, _, dec, tok = runs["card"]
        full = dict(prompts, tokens=torch.cat([prompts["tokens"], tok], 1))
        with torch.no_grad():
            logits_full, _, _ = card_model(full, mode="train")
        out["decode_vs_full_max_abs_err"] = _lm_close(
            dec[:, -1], logits_full[:, -1], LM_DECODE_TOL,
            f"{arch} decode against full context")
    return out


def _lm_free(dev):
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def _lm_serve(dev, arch: str, runs: int) -> tuple:
    """One full-width arch drawn on the card from SEED and served by
    ``serve_lm`` once cold and ``runs`` times warm on the same model: its
    parameter bytes, the memory before it, the warm runs' median times and
    the peak memory; the tokens in vocabulary and the prefill's logits
    finite.  Returns (record, model, prompts)."""
    cfg = get_config(arch)
    _lm_free(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = LM.LMModel(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    cold = serve_lm(cfg, model=model, device=dev)
    warm = [serve_lm(cfg, model=model, device=dev) for _ in range(runs)]
    toks = cold[0]
    check(toks.shape == (2, 8) and toks.min() >= 0
          and toks.max() < cfg.vocab_size,
          f"lm {arch}: tokens {toks.tolist()} outside [0, {cfg.vocab_size})")
    prompts = lm_prompts(cfg, seed=SEED, device=dev)
    logits, _ = LMST.make_prefill(cfg, max_len=24)(model, prompts)
    check(bool(torch.isfinite(logits).all()), f"lm {arch}: prefill logits "
          f"not finite")
    med = {key: statistics.median(w[2][key] for w in warm)
           for key in ("prefill_ms", "decode_ms_per_token")}
    wall = statistics.median(w[1] for w in warm)
    profiled = _lm_profile(dev, cfg, model, wall)
    rec = {"arch": arch, "dtype": cfg.dtype, "batch": 2, "prompt_len": 16,
           "decode_steps": 8,
           "param_count": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "allocated_before_bytes": before, "init_s": init_s,
           "cold_wall_s": cold[1], "cold_prefill_ms": cold[2]["prefill_ms"],
           "warm_runs": runs, "wall_s": wall, **med,
           "tokens_per_s": 2 * 8 / wall,
           "decode_tokens_per_s": 2 * 1e3 / med["decode_ms_per_token"],
           "peak_allocated_bytes": max(w[2]["peak_allocated_bytes"]
                                       for w in [cold, *warm]),
           "peak_reserved_bytes": max(w[2]["peak_reserved_bytes"]
                                      for w in [cold, *warm]),
           "tokens": toks.tolist(),
           "tokens_stable": all(np.array_equal(w[0], toks) for w in warm),
           "profiled": profiled}
    return rec, model, prompts


def _lm_profile(dev, cfg, model, wall: float) -> dict:
    """One more warm ``serve_lm`` run under torch.profiler (after one as its
    warm-up): its device kernels, their busy time against the unprofiled
    warm runs' median wall time, and the five that take the most."""
    from torch.profiler import ProfilerActivity, profile
    serve_lm(cfg, model=model, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_lm(cfg, model=model, device=dev)
        torch.cuda.synchronize(dev)
    events = list(_kernel_events(prof))
    busy_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:5]
    return {"kernels": sum(ev.count for ev in events),
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms
            else None,
            "top_device": [[ev.key[:80], ev.count,
                            ev.self_device_time_total / 1e3] for ev in top]}


def _lm_olmo_errors(dev, model, prompts) -> dict:
    """(c)'s two errors: the first decode step against a full-context
    forward (bf16 on the card), and bf16 against the same weights in
    float32 (train-mode logits over the prompt, prefill and first decode
    step), with whether the two prefills' greedy tokens agree."""
    cfg = model.cfg
    train, pre, dec, tok = _lm_step(cfg, model, prompts)
    full = dict(prompts, tokens=torch.cat([prompts["tokens"], tok], 1))
    with torch.no_grad():
        logits_full, _, _ = model(full, mode="train")
    out = {"decode_vs_full": _lm_rel(dec[:, -1], logits_full[:, -1],
                                     f"{cfg.name} decode against full "
                                     f"context")}
    f32 = LM.LMModel(dataclasses.replace(cfg, dtype="float32"), device=dev,
                     seed=SEED)
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    # the float32 model decodes the bf16 run's token, so that both steps
    # read the same input
    train32, pre32, dec32, _ = _lm_step(f32.cfg, f32, prompts, tok)
    out["bf16_vs_fp32"] = {
        name: _lm_rel(a, b, f"{cfg.name} bf16 {name} against float32")
        for name, a, b in (("train", train, train32), ("prefill", pre, pre32),
                           ("decode", dec, dec32))}
    out["bf16_vs_fp32"]["first_token_equal"] = torch.equal(
        tok[:, 0], torch.argmax(pre32[:, -1], dim=-1).to(torch.int32))
    return out


def phase_lm(dev, env: dict) -> dict:
    """The LM serving path (``repro_torch.launch.serve.serve_lm``) on the
    card: (a)–(d) of ``LM_*`` above, with the K1/K2/K3 counters set to 0
    just before and read just after (the path launches none of them)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _reset_counters()
    t0 = time.perf_counter()
    out = {"phase": "lm", "nvidia_smi": env["nvidia_smi"],
           "device": torch.cuda.get_device_name(dev),
           "smoke_tolerance": LM_SMOKE_TOL, "decode_tolerance": LM_DECODE_TOL,
           "smoke": {arch: _lm_smoke(dev, arch) for arch in sorted(LM_ARCHS)}}
    rec, model, prompts = _lm_serve(dev, LM_FULL, LM_RUNS)
    out["full"] = {LM_FULL: dict(rec, **_lm_olmo_errors(dev, model, prompts))}
    del model, prompts
    for arch in LM_FULL_OTHERS:
        rec, model, prompts = _lm_serve(dev, arch, 3)
        out["full"][arch] = rec
        del model, prompts
    _lm_free(dev)
    try:
        serve_lm(get_config(LM_REFUSED), device=dev)
    except ValueError as e:
        out["refused"] = {LM_REFUSED: str(e)}
    else:
        raise AssertionError(f"lm {LM_REFUSED}: the vision prefix fit the "
                             f"cache, where the JAX serve_lm raises")
    _lm_free(dev)
    launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches,
                "fused_ntt_tile": K3.launches}
    check(not any(launches.values()), f"lm: kernel launches {launches}")
    out["kernel_launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    return out


def _train_stream(cfg, **data) -> SyntheticLMStream:
    return SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seed=SEED,
        frontend_len=cfg.frontend_len if cfg.frontend else 0,
        d_model=cfg.d_model, **data))


def _leaves_close(got: dict, want: dict, tol: float, what: str) -> float:
    """Each tensor of ``got`` against ``want``'s of the same name, every
    element within tol·max|want| + tol·|want|; returns the largest error
    over that leaf's largest magnitude."""
    worst = 0.0
    for name, w in want.items():
        w = w.float().cpu()
        scale = float(w.abs().max())
        err = (got[name].float().cpu() - w).abs()
        check(bool((err <= tol * scale + tol * w.abs()).all()),
              f"train {what} {name}: max |err| {float(err.max())}, "
              f"tolerance {tol} of the leaf's largest magnitude {scale}")
        worst = max(worst, float(err.max()) / scale if scale else 0.0)
    return worst


def _train_smoke(dev, arch: str) -> dict:
    """(a): one smoke arch drawn on the CPU from SEED, copied to the card,
    one train step on each from the same state and batch."""
    cfg = smoke_config(arch)
    cpu_model, cpu_opt = LMST.init_train_state(cfg, seed=SEED, device="cpu")
    models = {"cpu": (cpu_model, cpu_opt)}
    card = copy.deepcopy(cpu_model).to(dev)
    models["card"] = (card, init_opt_state(card))
    if arch == TRAIN_FULL:
        card4 = copy.deepcopy(cpu_model).to(dev)
        models["card_accum4"] = (card4, init_opt_state(card4))
    batch = _train_stream(cfg, **TRAIN_SMOKE_DATA).batch_at(0)
    metrics = {}
    for where, (model, opt) in models.items():
        c = dataclasses.replace(cfg, grad_accum=4) if where == "card_accum4" \
            else cfg
        _, _, metrics[where] = LMST.make_train_step(c, TRAIN_SMOKE_OPT)(
            model, opt, batch_to_device(batch, model.device))
    out = {"loss": float(metrics["card"]["loss"])}
    for key in ("loss", "grad_norm"):
        out[f"{key}_max_abs_err"] = _lm_close(
            metrics["card"][key], metrics["cpu"][key], LM_SMOKE_TOL,
            f"train {arch} {key}, card against CPU")
    want = cpu_model.state_dict()
    out["params_max_abs_err"] = max(
        _lm_close(p, want[n], LM_SMOKE_TOL,
                  f"train {arch} parameter {n}, card against CPU")
        for n, p in card.state_dict().items())
    for key in ("m", "v"):
        out[f"{key}_max_rel_err"] = _leaves_close(
            models["card"][1][key], cpu_opt[key], LM_SMOKE_TOL,
            f"{arch} {key}, card against CPU,")
    if arch == TRAIN_FULL:
        got, ref = models["card_accum4"][0].state_dict(), card.state_dict()
        out["accum4"] = {
            "loss_abs_err": _lm_close(
                metrics["card_accum4"]["loss"], metrics["card"]["loss"],
                TRAIN_ACCUM_TOL, f"train {arch} grad_accum 4 loss"),
            "params_max_abs_err": max(
                _lm_close(p, ref[n], TRAIN_ACCUM_TOL,
                          f"train {arch} grad_accum 4 parameter {n}")
                for n, p in got.items()),
            "tolerance": TRAIN_ACCUM_TOL}
        for key in ("m", "v"):
            out["accum4"][f"{key}_max_rel_err"] = _leaves_close(
                models["card_accum4"][1][key], models["card"][1][key],
                TRAIN_ACCUM_TOL, f"{arch} grad_accum 4 {key}")
    return out


def _train_profile(dev, model, opt, step, stream, step_ms: float) -> dict:
    """One more step under torch.profiler: its device kernels, their busy
    time against the unprofiled steps' median, the five that take the
    most."""
    from torch.profiler import ProfilerActivity, profile
    batch = batch_to_device(next(stream), dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(model, opt, batch)
        torch.cuda.synchronize(dev)
    events = list(_kernel_events(prof))
    busy_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:5]
    gemm_ms = sum(ev.device_time_total for ev in prof.key_averages()
                  if ev.key in GEMM_OPS) / 1e3
    return {"kernels": sum(ev.count for ev in events),
            "device_busy_ms": busy_ms, "gemm_device_ms": gemm_ms,
            "device_idle_share": 1 - busy_ms / step_ms if busy_ms else None,
            "top_device": [[ev.key[:80], ev.count,
                            ev.self_device_time_total / 1e3] for ev in top]}


def _train_remat_ms(dev, model, opt, step, stream) -> dict:
    """Step ms (CUDA events, median of TRAIN_REMAT_STEPS after one warm-up)
    with remat off and under "nothing", on the same model and state."""
    cfg, out = model.cfg, {}
    for label, kw in (("off", dict(remat=False)),
                      ("nothing", dict(remat_policy="nothing"))):
        model.cfg = dataclasses.replace(cfg, **kw)
        times = []
        for _ in range(TRAIN_REMAT_STEPS + 1):
            batch = batch_to_device(next(stream), dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(model, opt, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[label] = statistics.median(times[1:])
    model.cfg = cfg
    return out


def _train_grads(cfg, model, batch) -> tuple:
    """(loss, grad_norm, {name: gradient}) of one batch, as the train step
    takes them (remat on)."""
    loss, _, grads = LMST._grads(cfg, model, dict(model.named_parameters()),
                                 batch)
    return float(loss), float(global_norm(grads.values())), grads


def _train_full(dev, remat_ms: bool) -> dict:
    """(b): olmo_1b at full width in bf16 through ``launch.train.build``:
    TRAIN_STEPS steps timed by CUDA events, memory, one profiled step (and
    with ``remat_ms`` the other remat settings' step ms); then its first
    step's loss and gradients against float32."""
    cfg = get_config(TRAIN_FULL)
    _lm_free(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, opt, step, stream = TRAIN.build(cfg, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rec = {"arch": TRAIN_FULL, "dtype": cfg.dtype, "remat": cfg.remat,
           "remat_policy": cfg.remat_policy,
           "seq_len": stream.cfg.seq_len, "global_batch": stream.cfg.global_batch,
           "param_count": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "opt_bytes": sum(t.numel() * t.element_size()
                            for key in ("m", "v") for t in opt[key].values()),
           "allocated_before_bytes": before, "init_s": init_s}
    steps = []
    for _ in range(TRAIN_STEPS):
        batch = batch_to_device(next(stream), dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        _, opt, metrics = step(model, opt, batch)
        end.record()
        loss = float(metrics["loss"])
        end.synchronize()
        steps.append({"ms": start.elapsed_time(end),
                      "host_ms": (time.perf_counter() - h0) * 1e3,
                      "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                      "lr": float(metrics["lr"])})
    losses = [s["loss"] for s in steps]
    check(all(np.isfinite(losses)), f"train {TRAIN_FULL}: losses {losses}")
    step_ms = statistics.median(s["ms"] for s in steps[-TRAIN_TIMED:])
    tokens = stream.cfg.seq_len * stream.cfg.global_batch
    rec.update(steps=steps, step_ms=step_ms,
               step_host_ms=statistics.median(
                   s["host_ms"] for s in steps[-TRAIN_TIMED:]),
               first_step_ms=steps[0]["ms"],
               tokens_per_step=tokens, tokens_per_s=tokens / step_ms * 1e3,
               peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
               peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
               profiled=_train_profile(dev, model, opt, step, stream,
                                       step_ms))
    if remat_ms:
        rec["remat_step_ms"] = dict(
            _train_remat_ms(dev, model, opt, step, stream), dots=step_ms)
    del model, opt, step
    _lm_free(dev)

    # the same weights (build draws them from seed 0) and batch_at(0), bf16
    # and float32, on the card
    batch = batch_to_device(stream.batch_at(0), dev)
    bf16 = LM.LMModel(cfg, device=dev, seed=SEED)
    loss_b, norm_b, grads_b = _train_grads(cfg, bf16, batch)
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = LM.LMModel(f32_cfg, device=dev, seed=SEED)
    f32.load_state_dict({k: v.float() for k, v in bf16.state_dict().items()})
    del bf16
    _lm_free(dev)
    loss_f, norm_f, grads_f = _train_grads(f32_cfg, f32, batch)
    del f32
    cos = {n: float(torch.nn.functional.cosine_similarity(
                grads_b[n].float().flatten(), grads_f[n].flatten(), dim=0))
           for n in grads_f}
    worst = min(cos, key=cos.get)
    rel = {"loss": abs(loss_b - loss_f) / abs(loss_f),
           "grad_norm": abs(norm_b - norm_f) / abs(norm_f)}
    for key, err in rel.items():
        check(err <= TRAIN_BF16_REL_TOL, f"train {TRAIN_FULL}: bf16 {key} "
              f"{err} relative to float32, above {TRAIN_BF16_REL_TOL}")
    check(cos[worst] >= TRAIN_GRAD_COS, f"train {TRAIN_FULL}: bf16 gradient "
          f"of {worst} at cosine {cos[worst]} to float32's")
    rec["bf16_vs_fp32"] = {
        "loss": [loss_b, loss_f], "grad_norm": [norm_b, norm_f],
        "rel_err": rel, "tolerance": TRAIN_BF16_REL_TOL,
        "grad_cosine_min": [worst, cos[worst]],
        "grad_cosine_median": statistics.median(cos.values()),
        "cosine_bound": TRAIN_GRAD_COS,
        "first_step_loss_of_run": steps[0]["loss"]}
    del grads_b, grads_f
    _lm_free(dev)
    return rec


def _train_demo(argv: list) -> tuple:
    """One ``examples.train_lm`` run on the card: (loop, printed lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loop = TRAIN_LM.main(["--steps", str(TRAIN_DEMO_STEPS), *argv],
                             ckpt_root=str(TRAIN_DIR))
    return loop, out.getvalue().splitlines()


def _train_loop() -> dict:
    """(c): the demo clean and with the injected fault; the final parameters
    of the two within TRAIN_LOOP_TOL."""
    runs = {label: _train_demo(argv) for label, argv in
            (("clean", []), ("faulty", ["--inject-fault"]))}
    clean, faulty = runs["clean"][0], runs["faulty"][0]
    want = clean.model.state_dict()
    out = {"params_max_abs_err": max(
        _lm_close(p, want[n], TRAIN_LOOP_TOL,
                  f"train demo: faulty run's {n} against the clean run's")
        for n, p in faulty.model.state_dict().items()),
        "tolerance": TRAIN_LOOP_TOL}
    for label, (loop, lines) in runs.items():
        losses = [m["loss"] for m in loop.metrics_log]
        k = max(len(losses) // 10, 1)
        out[label] = {"restarts": loop.restarts,
                      "first10": sum(losses[:k]) / k,
                      "last10": sum(losses[-k:]) / k,
                      "median_step_ms": loop.watchdog.median * 1e3,
                      "stragglers": loop.watchdog.flagged, "printed": lines}
        check(out[label]["last10"] < out[label]["first10"],
              f"train demo {label}: loss did not decrease "
              f"({out[label]['first10']} → {out[label]['last10']})")
    check(out["clean"]["restarts"] == 0 and out["faulty"]["restarts"] == 1,
          f"train demo: restarts {out['clean']['restarts']} clean, "
          f"{out['faulty']['restarts']} faulty")
    return out


def _train_cli() -> dict:
    """(d): ``python -m repro_torch.launch.train --arch olmo_1b --smoke`` as
    a subprocess on the card."""
    ckpt = TRAIN_DIR / "cli"
    shutil.rmtree(ckpt, ignore_errors=True)
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_FULL, "--smoke", "--steps", str(TRAIN_CLI_STEPS),
           "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ,
                                                PYTHONPATH=str(root / "src")))
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines
          and lines[-1].startswith(f"steps={TRAIN_CLI_STEPS} "),
          f"train CLI: exit {proc.returncode}, {proc.stdout[-500:]!r} "
          f"{proc.stderr[-2000:]!r}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"cmd": " ".join(cmd[1:]), "returncode": proc.returncode,
            "summary": lines[-1], "wall_s": wall}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _train_steps(dev, built, n: int) -> tuple:
    """``n`` steps of ``built`` = (model, opt, step, stream): per step its
    ms (CUDA events), loss and grad_norm; returns (steps, model, opt)."""
    model, opt, step, stream = built
    steps = []
    for _ in range(n):
        batch = batch_to_device(next(stream), dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model, opt, metrics = step(model, opt, batch)
        end.record()
        end.synchronize()
        steps.append({"ms": start.elapsed_time(end),
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"])})
    return steps, model, opt


def _whole(tree: dict) -> dict:
    """Each tensor of a dict, a DTensor gathered whole, on the CPU."""
    return {n: (t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().cpu() for n, t in tree.items()}


def _bit_equal(got: dict, want: dict, what: str) -> float:
    """Every tensor of ``got`` equal bit for bit to ``want``'s; returns the
    largest |difference| (0.0)."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        worst = max(worst, float((g.float() - w.float()).abs().max()))
        check(torch.equal(g, w), f"train mesh {what} {name}: not bit for "
              f"bit (max |diff| {worst})")
    return worst


def _train_mesh(dev) -> dict:
    """(e): a one-rank NCCL group; olmo_1b at full width on
    ``make_local_mesh()`` (1, 1, 1) against one device, and a smoke-width
    checkpoint from the mesh restored on one device."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    cfg = get_config(TRAIN_FULL)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = MESH.make_local_mesh(dev)
        _lm_free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        built = TRAIN.build(cfg, mesh=mesh)
        check(all(isinstance(p, DTensor) for p in built[0].parameters()),
              "train mesh: a parameter is not a DTensor")
        on_mesh, model, opt = _train_steps(dev, built, TRAIN_MESH_STEPS)
        mesh_params = _whole(dict(model.named_parameters()))
        peak_mesh = torch.cuda.max_memory_allocated(dev)
        profiled = {"mesh": _train_profile(
            dev, model, opt, built[2], built[3],
            statistics.median(s["ms"] for s in on_mesh))}
        del built, model, opt
        _lm_free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        built = TRAIN.build(cfg, device=dev)
        one, model, opt = _train_steps(dev, built, TRAIN_MESH_STEPS)
        one_params = _whole(dict(model.named_parameters()))
        peak_one = torch.cuda.max_memory_allocated(dev)
        profiled["one_device"] = _train_profile(
            dev, model, opt, built[2], built[3],
            statistics.median(s["ms"] for s in one))
        del built, model, opt
        _lm_free(dev)
        rel = {}
        for key in ("loss", "grad_norm"):
            got, want = ([s[key] for s in run] for run in (on_mesh, one))
            rel[key] = max(abs(g - w) / abs(w) for g, w in zip(got, want))
            check(rel[key] <= TRAIN_BF16_REL_TOL, f"train mesh {key}: {got} "
                  f"on the mesh, {want} on one device")
        params_rel = _leaves_close(mesh_params, one_params,
                                   TRAIN_BF16_REL_TOL, "mesh parameter")
        bit_equal = {
            "loss_grad_norm": [[a[k] == b[k] for k in ("loss", "grad_norm")]
                               for a, b in zip(on_mesh, one)],
            "params": all(torch.equal(mesh_params[n], one_params[n])
                          for n in one_params)}
        params_diff = max(float((mesh_params[n].float()
                                 - one_params[n].float()).abs().max())
                          for n in one_params)
        del mesh_params, one_params

        # a smoke-width checkpoint from the mesh, restored on one device
        smoke = smoke_config(TRAIN_FULL)
        model, opt, step, stream = TRAIN.build(smoke, mesh=mesh)
        _, model, opt = _train_steps(dev, (model, opt, step, stream), 1)
        ckpt = TRAIN_DIR / "mesh_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        save_checkpoint(str(ckpt), 1, {"params": model.state_dict(),
                                       "opt": opt})
        one_model, one_opt, _, _ = TRAIN.build(smoke, device=dev)
        tree, _ = restore_checkpoint(str(ckpt), {
            "params": one_model.state_dict(), "opt": one_opt})
        restored = {"params": _bit_equal(
            _whole(tree["params"]), _whole(model.state_dict()), "restored")}
        for key in ("m", "v"):
            restored[key] = _bit_equal(_whole(tree["opt"][key]),
                                       _whole(opt[key]), f"restored {key}")
        shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        dist.destroy_process_group()
    mesh_ms = statistics.median(s["ms"] for s in on_mesh)
    one_ms = statistics.median(s["ms"] for s in one)
    return {"arch": TRAIN_FULL, "dtype": cfg.dtype, "backend": "nccl",
            "world_size": 1, "mesh": dict(mesh.shape),
            "steps": TRAIN_MESH_STEPS, "mesh_steps": on_mesh,
            "one_device_steps": one, "mesh_step_ms": mesh_ms,
            "one_device_step_ms": one_ms, "mesh_over_one_device": mesh_ms
            / one_ms, "peak_allocated_bytes": {"mesh": peak_mesh,
                                               "one_device": peak_one},
            "profiled": profiled,
            "rel_err": rel, "params_max_abs_diff": params_diff,
            "params_max_rel_err": params_rel, "bit_equal": bit_equal,
            "tolerance": TRAIN_BF16_REL_TOL,
            "smoke_checkpoint_max_abs_diff": restored,
            "smoke_checkpoint_tolerance": "bit for bit"}


def phase_train(dev, env: dict, remat_ms: bool = False) -> dict:
    """The LM training path (``repro_torch.launch.train``,
    ``repro_torch.examples.train_lm``) on the card: (a)–(e) of ``TRAIN_*``
    above, with the K1/K2/K3 counters set to 0 just before and read just
    after (the path launches none of them).  ``remat_ms`` adds (b)'s
    diagnostic steps under the other remat settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    _reset_counters()
    t0 = time.perf_counter()
    out = {"phase": "train", "nvidia_smi": env["nvidia_smi"],
           "device": torch.cuda.get_device_name(dev),
           "smoke_tolerance": LM_SMOKE_TOL,
           "smoke": {arch: _train_smoke(dev, arch)
                     for arch in sorted(LM_ARCHS)}}
    _lm_free(dev)
    out["full"] = _train_full(dev, remat_ms)
    out["loop"] = _train_loop()
    _lm_free(dev)
    out["cli"] = _train_cli()
    _lm_free(dev)
    out["mesh"] = _train_mesh(dev)
    launches = {"limb_matmul": K1.launches, "mont_fold": K2.launches,
                "fused_ntt_tile": K3.launches}
    check(not any(launches.values()), f"train: kernel launches {launches}")
    out["kernel_launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    return out


# --- dist: GPipe, the int8 gradient sync, W8A8 --------------------------------


def _counts() -> dict:
    return {"limb_matmul": K1.launches, "mont_fold": K2.launches,
            "fused_ntt_tile": K3.launches}


def _profiled(fn, dev, wall_ms: float) -> dict:
    """One call of ``fn`` under torch.profiler (after one as its warm-up):
    its device kernels, their busy time against ``wall_ms`` (an unprofiled
    call's median) and the device's idle share over it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    events = list(_kernel_events(prof))
    busy_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    return {"kernels": sum(ev.count for ev in events),
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None}


def _timed_ms(fn, dev, runs: int) -> float:
    """Median of ``runs`` calls of ``fn`` between CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _dist_gpipe(dev) -> dict:
    """(a) olmo_1b's 16 decoder layers as DIST_STAGES stages on a ``pod``
    axis of as many positions, all on the card: DIST_MICRO microbatches of
    (2, 128) hidden states through ``pipeline_forward``, equal bit for bit
    to the same stages applied serially per microbatch, within
    LM_BF16_REL_TOL of one pass of all the microbatches at once; the
    pipeline's and the serial run's times (CUDA events, median), stage
    calls, kernels and idle share."""
    cfg = get_config(LM_FULL)
    model = LM.LMModel(cfg, device=dev, seed=SEED)
    per = cfg.n_layers // DIST_STAGES
    stages = [model.layers[i * per:(i + 1) * per] for i in range(DIST_STAGES)]
    mesh = MESH.make_mesh((DIST_STAGES,), ("pod",), [dev])
    b, s = DIST_MB
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn((DIST_MICRO, b, s, cfg.d_model), generator=gen,
                     device=dev).to(torch_dtype(cfg))
    calls = [0]
    stage_fn = _olmo_stage_fn(cfg, dev, calls)

    def pipeline():
        return pipeline_forward(stage_fn, stages, xs, mesh=mesh, axis="pod")

    def serial():
        outs = []
        for j in range(DIST_MICRO):
            h = xs[j]
            for st in stages:
                h = stage_fn(st, h)
            outs.append(h)
        return torch.stack(outs)

    with torch.no_grad():
        calls[0] = 0
        out = pipeline()
        pipe_calls = calls[0]
        calls[0] = 0
        ref = serial()
        serial_calls = calls[0]
        check(torch.equal(out, ref), "dist gpipe: the pipeline differs from "
              "the serial per-microbatch run")
        whole = xs.reshape(DIST_MICRO * b, s, cfg.d_model)
        positions_all = torch.arange(s, device=dev)[None].expand(
            DIST_MICRO * b, s)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for lp in model.layers:
            whole, aux, _ = LM._decoder_layer(cfg, lp, whole, aux,
                                              positions=positions_all,
                                              mode="train")
        once = _lm_rel(out.reshape(whole.shape), whole,
                       "dist gpipe against one pass")
        pipe_ms = _timed_ms(pipeline, dev, DIST_RUNS)
        serial_ms = _timed_ms(serial, dev, DIST_RUNS)
        rec = {"stages": DIST_STAGES, "layers_per_stage": per,
               "microbatches": DIST_MICRO, "microbatch": [b, s],
               "d_model": cfg.d_model, "dtype": cfg.dtype,
               "stage_calls": pipe_calls, "serial_stage_calls": serial_calls,
               "ticks": DIST_MICRO + DIST_STAGES - 1,
               "bubble_fraction": bubble_fraction(DIST_STAGES, DIST_MICRO),
               "bit_equal_serial": True, "vs_one_pass": once,
               "pipeline_ms": pipe_ms, "serial_ms": serial_ms,
               "pipeline_over_serial": pipe_ms / serial_ms,
               "predicted_ratio": pipe_calls / serial_calls,
               "pipeline_profiled": _profiled(pipeline, dev, pipe_ms),
               "serial_profiled": _profiled(serial, dev, serial_ms)}
    del model, stages, xs, out, ref, whole
    _lm_free(dev)
    return rec


def _grad_tree(cfg, dev, dtype=None) -> dict:
    """A seeded normal gradient per parameter of ``cfg``'s model (names and
    shapes from the meta model), drawn on ``dev`` in ``dtype`` (the
    config's by default)."""
    shapes = {n: p.shape for n, p in SPECS.abstract_params(cfg)
              .named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dt = dtype or torch_dtype(cfg)
    return {n: torch.randn(shape, generator=gen, device=dev).to(dt)
            for n, shape in shapes.items()}


def _dist_compression(dev) -> dict:
    """(b) ``compressed_grad_sync`` of olmo_1b's gradient tree (bf16,
    seeded normal) over a ``pod`` axis of DIST_STAGES positions on the
    card: every synced leaf within its scale (max |g| / 127) of the
    gradient and the new error state within it; ms per sync (CUDA events,
    median), peak memory, bytes sent as int8 against an int32 psum's; and
    on the smoke tree the card equal to the CPU bit for bit."""
    cfg = get_config(LM_FULL)
    mesh = MESH.make_mesh((DIST_STAGES,), ("pod",), [dev])
    smoke = smoke_config(LM_FULL)
    g_cpu = _grad_tree(smoke, torch.device("cpu"), torch.float32)
    cpu_mesh = MESH.make_mesh((DIST_STAGES,), ("pod",), ["cpu"])
    want = compressed_grad_sync(g_cpu, init_error_state(g_cpu),
                                mesh=cpu_mesh)
    g_card = {n: g.to(dev) for n, g in g_cpu.items()}
    got = compressed_grad_sync(g_card, init_error_state(g_card), mesh=mesh)
    for w_tree, g_tree, what in ((want[0], got[0], "synced"),
                                 (want[1], got[1], "error state")):
        bad = [n for n in w_tree if not torch.equal(w_tree[n],
                                                    g_tree[n].cpu())]
        check(not bad, f"dist compression smoke: the card's {what} differs "
              f"from the CPU's at {bad[:4]}")
    _lm_free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    grads = _grad_tree(cfg, dev)
    err = init_error_state(grads)
    synced, new_err = compressed_grad_sync(grads, err, mesh=mesh)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    worst = {"synced_over_scale": 0.0, "error_over_scale": 0.0}
    for n, g in grads.items():
        scale = float(g.float().abs().max()) / 127.0
        d = float((synced[n].float() - g.float()).abs().max())
        e = float(new_err[n].abs().max())
        check(d <= scale and e <= scale, f"dist compression {n}: synced "
              f"off by {d}, error state {e}, scale {scale}")
        worst["synced_over_scale"] = max(worst["synced_over_scale"],
                                         d / scale)
        worst["error_over_scale"] = max(worst["error_over_scale"], e / scale)
    del synced, new_err
    sync_ms = _timed_ms(lambda: compressed_grad_sync(grads, err, mesh=mesh),
                        dev, DIST_SYNC_RUNS)
    rec = {"positions": DIST_STAGES, "leaves": len(grads),
           "elements": sum(g.numel() for g in grads.values()),
           "grad_bytes": sum(g.numel() * g.element_size()
                             for g in grads.values()),
           "error_state_bytes": sum(e.numel() * 4 for e in err.values()),
           "smoke_card_equal_cpu": True, **worst,
           "sync_ms": sync_ms, "allocated_before_bytes": before,
           "peak_allocated_bytes": peak,
           "wire_bytes": wire_bytes(grads, DIST_STAGES)}
    del grads, err
    _lm_free(dev)
    return rec


def _dist_aqt(dev) -> dict:
    """(c) ``QuantizedLinear`` on olmo_1b's ``mlp/wi_gate`` shape with
    DIST_AQT_TOKENS tokens: the card's ``int32_native`` output (the
    product by ``torch._int_mm``) equal bit for bit to the CPU's plain
    integer path on the same inputs and within 0.05 of the bf16 product;
    its µs against ``torch.matmul`` in bf16; and an exact-window case (K =
    2048 < ``exact_k_bound``, inputs on the int8 grid) equal to the int64
    product over 127²."""
    cfg = get_config(LM_FULL)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    w = (torch.randn((cfg.d_model, cfg.d_ff), generator=gen) * 0.02).to(
        torch.bfloat16)
    x = torch.randn((DIST_AQT_TOKENS[0], DIST_AQT_TOKENS[1], cfg.d_model),
                    generator=gen).to(torch.bfloat16)
    layer = QuantizedLinear(w.to(dev))
    out = layer(x.to(dev))
    want = QuantizedLinear(w)(x)
    check(torch.equal(out.cpu(), want), "dist aqt: the card's int32 path "
          "differs from the CPU's")
    ref = x.to(dev) @ w.to(dev)
    rel = float((out.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    check(rel <= 0.05, f"dist aqt: {rel} of the bf16 product")
    xd, wd = x.to(dev), w.to(dev)
    times = median_ms_turns({"aqt": lambda: layer(xd),
                             "bf16_matmul": lambda: xd @ wd}, dev, runs=20)
    k = 2048
    check(k < exact_k_bound("int32_native"), "dist aqt: K past the window")
    rng = np.random.default_rng(SEED)
    xi = rng.integers(-127, 128, (64, k))
    wi = rng.integers(-127, 128, (k, 256))
    xq = torch.as_tensor(xi, dtype=torch.float32, device=dev) / 127.0
    got = quantized_matmul(xq, torch.as_tensor(wi, dtype=torch.int8,
                                               device=dev),
                           torch.full((1, 256), 1.0 / 127.0, device=dev))
    exact = (xi @ wi).astype(np.float64) / (127.0 * 127.0)
    window_err = float(np.abs(got.cpu().double().numpy() - exact).max()
                       / np.abs(exact).max())
    check(window_err <= 1e-6, f"dist aqt exact window: {window_err}")
    return {"shape": [list(x.shape), list(w.shape)], "accum": "int32_native",
            "card_equal_cpu": True, "rel_err_vs_bf16": rel,
            "aqt_us": times["aqt"] * 1e3,
            "bf16_matmul_us": times["bf16_matmul"] * 1e3,
            "exact_window": {"k": k, "bound": exact_k_bound("int32_native"),
                             "rel_err": window_err}}


def _olmo_stage_fn(cfg, dev, calls: list):
    """olmo_1b's decoder layers applied to a (2, 128) microbatch of hidden
    states, counting its calls."""
    b, s = DIST_MB
    positions = torch.arange(s, device=dev)[None].expand(b, s)

    def stage_fn(layers, x):
        calls[0] += 1
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in layers:
            x, aux, _ = LM._decoder_layer(cfg, lp, x, aux,
                                          positions=positions, mode="train")
        return x
    return stage_fn


def _dist_process_group(dev) -> dict:
    """(d) the process-group forms (``compressed_grad_sync`` and
    ``pipeline_forward`` given a ``DeviceMesh``) on a one-rank NCCL group:
    a ``pod`` axis of one rank on the card against the single-controller
    forms on a one-position ``pod`` axis, bit for bit: the sync of (b)'s
    olmo_1b gradient tree, and GPipe of (a)'s 16 layers as one stage on
    DIST_MICRO microbatches; ms of each form (CUDA events, median)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        one = MESH.make_mesh((1,), ("pod",), [dev])
        dmesh = MESH.device_mesh(one, "cuda")
        cfg = get_config(LM_FULL)
        grads = _grad_tree(cfg, dev)
        err = init_error_state(grads)
        got = compressed_grad_sync(grads, err, mesh=dmesh)
        want = compressed_grad_sync(grads, err, mesh=one)
        for w_tree, g_tree, what in ((want[0], got[0], "synced"),
                                     (want[1], got[1], "error state")):
            bad = [n for n in w_tree if not torch.equal(w_tree[n],
                                                        g_tree[n])]
            check(not bad, f"dist process group: the {what} differs from "
                  f"the single controller's at {bad[:4]}")
        del got, want
        sync_ms = {
            "process_group": _timed_ms(lambda: compressed_grad_sync(
                grads, err, mesh=dmesh), dev, DIST_SYNC_RUNS),
            "single_controller": _timed_ms(lambda: compressed_grad_sync(
                grads, err, mesh=one), dev, DIST_SYNC_RUNS)}
        sync = {"leaves": len(grads), "bit_equal": True,
                "elements": sum(g.numel() for g in grads.values()),
                "sync_ms": sync_ms}
        del grads, err
        _lm_free(dev)
        model = LM.LMModel(cfg, device=dev, seed=SEED)
        calls = [0]
        stage_fn = _olmo_stage_fn(cfg, dev, calls)
        stages = [model.layers]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        xs = torch.randn((DIST_MICRO, *DIST_MB, cfg.d_model), generator=gen,
                         device=dev).to(torch_dtype(cfg))
        with torch.no_grad():
            out_pg = pipeline_forward(stage_fn, stages, xs, mesh=dmesh)
            pg_calls, calls[0] = calls[0], 0
            out_sc = pipeline_forward(stage_fn, stages, xs, mesh=one)
            check(torch.equal(out_pg, out_sc), "dist process group: GPipe "
                  "differs from the single controller's")
            gpipe_ms = {
                "process_group": _timed_ms(lambda: pipeline_forward(
                    stage_fn, stages, xs, mesh=dmesh), dev, DIST_RUNS),
                "single_controller": _timed_ms(lambda: pipeline_forward(
                    stage_fn, stages, xs, mesh=one), dev, DIST_RUNS)}
        gpipe = {"stages": 1, "layers_per_stage": cfg.n_layers,
                 "microbatches": DIST_MICRO, "stage_calls": pg_calls,
                 "bit_equal": True, "pipeline_ms": gpipe_ms}
        del model, stages, xs, out_pg, out_sc
        _lm_free(dev)
    finally:
        dist.destroy_process_group()
    return {"backend": "nccl", "world_size": 1, "mesh": {"pod": 1},
            "compression": sync, "gpipe": gpipe}


# (e) four gloo ranks on the one card: the sync of the smoke gradient tree,
# each rank against the single-controller form it runs itself on a
# 4-position axis on the card.  GPipe is not run there: gloo's TCP pairs
# write a tensor from its address, and a CUDA tensor's send fails ("writev
# ... Bad address"), which aborts the rank from gloo's own thread (SIGABRT,
# no Python exception; see PERF.md §6).
DIST_GLOO_RANKS = 4
DIST_GLOO_TIMEOUT_S = 300


def _gloo_rank(rank: int, init: str, out: str):
    """One rank of (e): the sync's all-gather and all-reduce on CUDA
    tensors through a gloo group; its result against the single
    controller's, and its ms (CUDA events, median)."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=DIST_GLOO_RANKS)
    try:
        mesh = MESH.make_mesh((DIST_GLOO_RANKS,), ("pod",), [dev])
        dmesh = MESH.device_mesh(mesh, "cuda")
        grads = _grad_tree(smoke_config(LM_FULL), dev)
        err = init_error_state(grads)
        got = compressed_grad_sync(grads, err, mesh=dmesh)
        want = compressed_grad_sync(grads, err, mesh=mesh)
        res = {"rank": rank, "bit_equal": all(
            torch.equal(got[i][n], want[i][n]) for i in (0, 1)
            for n in grads),
            "sync_ms": _timed_ms(lambda: compressed_grad_sync(
                grads, err, mesh=dmesh), dev, DIST_SYNC_RUNS)}
    finally:
        dist.destroy_process_group()
    Path(out, f"gloo_cuda_rank{rank}.json").write_text(json.dumps(res))


def _dist_gloo_cuda() -> dict:
    """(e): DIST_GLOO_RANKS spawned processes, one gloo group, every rank
    on the one card; every rank's sync must equal the single controller's
    bit for bit."""
    import torch.multiprocessing as mp
    tmp = OUT / "gloo_cuda"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    workers = mp.start_processes(_gloo_rank, args=(f"file://{tmp / 'store'}",
                                                   str(tmp)),
                                 nprocs=DIST_GLOO_RANKS, join=False,
                                 start_method="spawn")
    deadline = time.monotonic() + DIST_GLOO_TIMEOUT_S
    while not workers.join(timeout=1):
        if time.monotonic() > deadline:
            for p in workers.processes:
                p.kill()
            raise AssertionError(f"dist gloo: the {DIST_GLOO_RANKS} ranks did "
                                 f"not finish in {DIST_GLOO_TIMEOUT_S} s")
    ranks = [json.loads((tmp / f"gloo_cuda_rank{r}.json").read_text())
             for r in range(DIST_GLOO_RANKS)]
    check(all(r["bit_equal"] for r in ranks), "dist gloo: a rank's sync "
          "differs from the single controller's")
    return {"backend": "gloo", "world_size": DIST_GLOO_RANKS,
            "device": "cuda:0 for every rank", "compression_bit_equal": True,
            "sync_ms": [r["sync_ms"] for r in ranks],
            "gpipe": "not run: gloo cannot send a CUDA tensor",
            "wall_s": time.perf_counter() - t0}


def phase_dist(dev, env: dict) -> dict:
    """(a)–(e) of ``DIST_*`` above on the card, with the K1/K2/K3 counters
    set to 0 just before and read just after (no Pallas kernel lies on
    these paths, so all stay 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _reset_counters()
    t0 = time.perf_counter()
    out = {"phase": "dist", "nvidia_smi": env["nvidia_smi"],
           "device": torch.cuda.get_device_name(dev),
           "gpipe": _dist_gpipe(dev), "compression": _dist_compression(dev),
           "aqt": _dist_aqt(dev),
           "process_group": _dist_process_group(dev),
           "gloo_cuda": _dist_gloo_cuda()}
    launches = _counts()
    check(not any(launches.values()), f"dist: kernel launches {launches}")
    out["kernel_launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    env = phase_env(dev)
    if sys.argv[1:] == ["--k3"]:
        # a short call: the build, K3's resources, checks and times, no more
        rng = np.random.default_rng(SEED + 3)
        emit({"phase": "k3_checks", **k3_checks(dev, rng)})
        emit({"phase": "k3_timings", "fused_ntt_tile": k3_timings(dev, env["device"], rng)})
        return
    if sys.argv[1:] == ["--validator"]:
        # a short call: the build and the validator phase
        phase_validator(dev)
        return
    if sys.argv[1:] == ["--online"]:
        # a short call: the build and the online phase, its reference rows
        # from the CPU replays of its two traces
        phase_online(dev, env, {"paper": _cpu_rows(),
                                "mixed": _cpu_rows(256, **MIXED)})
        return
    if sys.argv[1:] == ["--cluster"]:
        # a short call: the build and the cluster phase, its reference rows
        # from the CPU replay of the paper trace
        phase_cluster(dev, env, _cpu_rows())
        return
    if sys.argv[1:] == ["--k2"]:
        # a short call: the build, K2's checks, times and pass spans, and
        # K3's checks (K3 folds with K2's code), no more
        rng = np.random.default_rng(SEED)
        emit({"phase": "k2_checks", **k2_checks(dev, rng)})
        k2 = k2_timings(dev, env["device"], rng)
        emit({"phase": "k2_timings", **k2,
              "pass_span": pass_spans(dev, rng, k2["mont_fold"])})
        emit({"phase": "k3_checks",
              **k3_checks(dev, np.random.default_rng(SEED + 3))})
        return
    if sys.argv[1:] == ["--variants"]:
        # a short call: the build and the variants phase
        phase_variants(dev, env)
        return
    if sys.argv[1:] == ["--examples"]:
        # a short call: the build and each example's main on the card
        phase_examples(dev, env)
        return
    if sys.argv[1:] == ["--dryrun"]:
        # a short call: the build, the four crypto cells of the dry run and
        # its LM cells on the production meshes
        phase_dryrun(dev, env)
        return
    if sys.argv[1:] == ["--lm"]:
        # a short call: the build and the LM phase
        phase_lm(dev, env)
        return
    if sys.argv[1:] == ["--dist"]:
        # a short call: the build and the dist phase
        phase_dist(dev, env)
        return
    if sys.argv[1:] in (["--train"], ["--train", "--remat-ms"]):
        # a short call: the build and the train phase (with the remat
        # diagnostic)
        phase_train(dev, env, remat_ms="--remat-ms" in sys.argv)
        return
    kern = phase_kernels(dev, env["device"])
    phase_engines(dev)
    phase_variants(dev, env)
    fused = phase_fused(dev, env["device"])
    _, paper_rows = phase_slice(dev, "paper")
    _, mixed_rows = phase_slice(dev, "mixed_eager_lazy", d_uniform=256,
                                **MIXED)
    # the kernels line's K1/K2 launches: the kernel events the profiler saw
    # in a warm paper replay, the counters set to 0 just before it (and
    # equal to them)
    launched = phase_profile(dev)["census_by_profiler"]["events"]
    phase_validator(dev)
    phase_online(dev, env, {"paper": paper_rows, "mixed": mixed_rows})
    phase_cluster(dev, env, paper_rows)
    phase_examples(dev, env)
    phase_dryrun(dev, env)
    phase_lm(dev, env)
    phase_train(dev, env)
    phase_dist(dev, env)

    rows = []
    for name, replaces, timed, launches, err in (
            ("limb_matmul", "src/repro/kernels/limb_matmul/kernel.py:44",
             kern["limb_matmul"][0], launched["limb_matmul"],
             kern["max_abs_err"]["limb_matmul"]),
            ("mont_fold", "src/repro/kernels/mont_fold/kernel.py:35",
             kern["mont_fold"][0], launched["mont_fold"],
             kern["max_abs_err"]["mont_fold"]),
            ("fused_ntt_tile", "src/repro/kernels/fused_ntt_tile/kernel.py:58",
             fused["fused_ntt_tile"][0], fused["launches"],
             fused["max_abs_err"])):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces,
                     "launches": launches,
                     "max_abs_err": err,
                     "ms": timed["kernel_ms"],
                     "device_ms": timed["kernel_device_ms"],
                     "plain_ms": timed["plain_ms"],
                     "bound_ms": timed["bound_ms"],
                     "bound_by": timed["bound_by"],
                     "library_ms": timed["library_ms"]})
    emit({"total_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
