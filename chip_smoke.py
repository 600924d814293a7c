"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (each one failing stops the script with a nonzero exit):

1. device: the card's name and power limit; TF32 switched off.
2. build: compile ``src/repro_torch/csrc/*.cu`` (nvcc, sm_90a) and print the
   build time per file and the ptxas register/spill/shared-memory report per
   kernel; no K5 kernel and no K4 instance (wgmma or split path) spills,
   and ptxas serialises the wgmma of no K4 instance, and K1's inline passes
   do not spill;
   check in the SASS that K3's prefill path and every K4 instance issue
   wgmma (HGMMA) and TMA loads (UTMALDG), every K4 instance a TMA store
   (UTMASTG), and that no K3, K4 or K5 kernel has a global atomic.
3. kernels: every kernel (K1 sr_quant, K2 sr_pack, K3 quant_matmul, K4
   flash_attention, K5 flash_decode) against its plain PyTorch version on the
   card, at the shapes of its path, with times beside the plain version, one
   library call where one computes the same function, and the card's bound;
   K1 through its three entries: the u-taking segment entry, the keyed
   segment entry (fl-sim: scales and Philox4x32-10 uniforms made in the
   kernel; bit-equal at 1, 3 and 7 ragged leaves and 1-4 clients, the fl
   rounds' leaves, zero, NaN and unaligned leaves; timed at the fl rounds'
   shapes and one 4096 x 11008 leaf beside the parent's chain) and the
   trainer's keyed inline entry (Random123's known answers on the card;
   bit-equal at bits 4-32, n 1-4099, f32 and bf16 out, an unaligned base;
   timed at a 4096 x 11008 and a 4096 x 512 weight use beside the parent's
   chain of operations at the same shape, and beside PyTorch's max|w|
   reductions); K2 through both entries: the u-taking one and the wire's
   keyed one (guard, scales, pitch and uniforms in the kernel; codes,
   pitch and non-finite count bit-equal at bits 4-16 into int8/16/32, 1-7
   leaves, 1-4 clients, the pitch at every bits 1-31, NaN and +-Inf, an
   unaligned base; timed at the trainer's wire and at 4 x 4096 x 11008 in
   int8 and int16 beside the parent's chain); the keyed entries on trees
   past one table (K1 at 65 leaves, K2 at 26 x 10 and 4 x 70) through
   ``ops``, bit-equal to the plain split, to the u-taking entry fed the
   key's streams and to the one-table call; K3 at the MoE experts' shapes
   (olmoe, qwen3; M 4 and a 4 x 128 prefill's capacity) and at the
   projections of mamba2 (M 4), seamless-m4t (M 4 and its encoder's M 4 x
   256), llama-3.2-vision (M 4, and the image memory's M 4 x 1,601) and
   yi-6b as one data shard of phase serve_dist runs it (M 1 at its five
   projections, M 64 and 128 at its four layer projections),
   each plan printed and asserted (the 50,280- and 256,206-byte code rows of
   mamba2's and seamless-m4t's unembeds, and every other M <= 16 shape TMA
   cannot address, on the ragged path, each timed beside the old tiled plan
   too) beside ``torch.matmul``; the ragged path at its edge cases
   (``check_quant_matmul_ragged``: M 1-16, N 1, 2, 12 and 301, K 7, 1,001
   and 1,536, f32 and bf16 x, int8 and int16 codes, operands one element
   into a buffer or at its end; NaN-filled outputs, untimed);
   K3, K4 and K5 also launched twice on identical inputs, the outputs
   bit-equal.  K4's rows name the path and tiles of
   ``plan_attention`` and the SDPA backend of their library time (fused:
   flash for bf16, memory-efficient for f32, on 4-D views of the same
   tensors): f32 at head dims 16-256 (the split path; its bound prices the
   operations as three bf16 products) and bf16 at 16, 32, 64, 128 and 256,
   at S 100, 128 and 513 where the head dim's model runs them, seamless-m4t's
   encoder (BH 64, S 256, D 64; bf16 and f32, non-causal and causal) and
   llama-3.2-vision's prefill (BH 256, S 64, D 128, bf16) and a yi-6b
   shard's one-slot prefill (BH 32, S 64 and 128, D 128, bf16); then one-hot
   inputs through every K4 tile of both paths, which show where each
   element of q, K and V lands at every swizzle K4 uses.  K5 rows: yi-6b's
   decode, gemma-7b's (G 1, hd 256), glm4-9b's (G 16), seamless-m4t's (KV
   16, G 1, hd 64), llama-3.2-vision's (KV 8, G 8, hd 128) and a long
   context (n_pmax 256, ~4,000 tokens a slot) and a yi-6b shard's one slot
   (B 1), each with its block count
   from ``plan_decode``.  Phase serve_tp's per-rank shapes too: K3 at the
   projections of yi-6b and glm4-9b on one of 4 model shards, in bf16 at
   the serves' M 4 (decode) and M 512 (prefill) and in f32 at the
   step-level runs' M 4 and M 800; K4 at BH 4 x 8, D 128, S 128 in bf16
   (the yi-6b shard row's shape) and S 200 in f32; K5 at yi-6b's one KV
   head a shard and at glm4-9b's sequence shard (KV 2, G 16, n_pmax 4, a
   slot of local length 0).  Phase serve_tp_families' per-rank shapes too
   (``K3_MODEL_SHAPES``' "one of 4 model shards" rows of mamba2,
   seamless-m4t, llama-3.2-vision and the smoke jamba, bf16 and f32; K4 at
   BH 16 x S 256 x D 64 and BH 64 x S 64 x D 128; K5 at KV 4 / G 1 / hd 64,
   KV 2 / G 8 / hd 128 and KV 1 / G 1 / hd 16).
4. serve: ``Session.serve`` of full-width, full-depth yi-6b, then of
   gemma-7b (head dim 256), olmoe-1b-7b (64 experts, top-8) and mamba2-780m
   (48 SSM layers), of the smoke-size jamba (the hybrid), of seamless-m4t
   (enc-dec, 24 + 24 layers) and of llama-3.2-vision cut to 2 periods (10
   layers at d 8192), with int8 weights, paged f32 KV (mamba2's O(1) state
   contiguous: the session's fallback) and continuous batching; the launch
   counters are zeroed just before each run and read just after, each run
   must have launched its family's kernels (K3, K4, K5; mamba2 K3 alone;
   jamba K3 and K5) and no other of the three; the families that prefill in
   one pass launch exactly their counts a prefill and a decode step times
   the prefills and decode steps the session ran (``expected_launches``),
   K4 causal (non-causal for the enc-dec encoder); the recurrent ones K3 a
   whole number of passes (``5L + 1`` SSM, by sublayer kind for the
   hybrid; a prefill by decode is one pass a token); every MoE
   ``expert_dispatch`` on its K3 branch (never the eager dequant); each K3
   shape's plan recorded and asserted (``k3_path``: the unembed ragged at
   mamba2's and seamless-m4t's vocabularies, cluster at the others').
5. profile: where a full-depth decode step's and a prefill's (4 slots x 128
   tokens; mamba2's by decode, 4 x 16; seamless-m4t's the encoder over 4 x
   256 frames and the cross K/V; llama-3.2-vision's 4 x 64 at 2 periods)
   time goes, for yi-6b, olmoe-1b-7b, mamba2-780m, seamless-m4t and
   llama-3.2-vision: host clock, device time by kernel from
   ``torch.profiler``, K3's, K4's and K5's device time, K3's share and
   launches, K3's launches by shape.
6. consistency: a 2-layer full-width yi-6b (bf16, then f32 compute: K4's
   split path), a 4-layer full-width gemma-7b, a 2-layer full-width
   qwen3-moe-235b-a22b (f32, 128 experts, K5 at G 16), a 2-layer
   full-width mamba2-780m, the smoke-size jamba (f32), seamless-m4t at 2 +
   2 layers (f32: its encoder on K4's split path, non-causal, head dim 64)
   and llama-3.2-vision at one period (bf16, the cross gates non-zero) each
   run one prefill and one decode step with the kernels and again with the
   plain versions on the card; then the smoke-size yi-6b (f32, head dim 16)
   serves through
   ``Session.serve`` with K4 launched on the split path only.
7. fl: the paper's FWQ loop (``Session.run_fl_sim``) on the card — the
   quickstart ``mobilenet`` spec and the ``fl-codesign-grid`` ``resnet``
   spec, 10 rounds each, 8 clients, one call of K1's keyed segment entry per
   round — checked against a CPU run of the same specs (host math exactly
   equal), one round run through K1 and through the plain version
   (quantized parameters bit-equal, and equal to the u-taking entry fed
   ``round_uniforms``), and profiled.
8. train: the pod trainer (``Session.run_train``) on full-width yi-6b cut to
   8 layers, a 4x1 mesh (4 clients on the card): 3 rounds of
   ``fl-orchestrate`` (scheme unified_q, int16 SR gradient wire) and 2 rounds of
   ``train`` at fixed 8-bit weights (int8 wire); per round the loss, plan,
   step time, K1/K2 launches and peak memory; exactly 456 K1 launches (the
   inline entry, one a weight use) and one call of K2's keyed entry a step;
   a profiled round (device ms by family, busy share, host syncs); one
   weight use through the inline K1 and the keyed K2 on a step's real
   replicated gradients against their plain versions; the rounds' plans
   against a CPU run of the same orchestrator.  Then 2 rounds of ``train``
   on olmoe-1b-7b at full width cut to 2 layers (4x1, sequence 256): finite
   losses, 120 K1 launches (every expert stack one weight use, the router
   exempt) and one keyed K2 call a step, peak memory under 40 GB, a
   profiled round.  Then 2 rounds of ``train`` on mamba2-780m at full width
   cut to 8 layers (4x1, sequence 512: two SSD chunks): finite losses, 328
   K1 launches and one keyed K2 call a step, a profiled round.  Then 2
   rounds of ``train`` on seamless-m4t at full width cut to 4 + 4 layers
   (4x1, sequence 256): finite losses, 588 K1 launches and one keyed K2
   call a step, a profiled round.
9. grids: committed cells of the JAX package's sweep stores rerun through
   the port's ``SweepRunner`` on the card, with the stores in a temporary
   directory: grad-comm-wire at comm 8 and serve-precision-ablation at 7
   and 12 bits (kv 32, paged), each in a child process, and fl-fault-grid
   unified_q severe in this process; every row ``ok``, its exact facts
   equal: a serve or wire cell's byte counts and scheduling to the
   committed row, an fl cell's energy, time, bits and fault counters to
   the reference's own rerun on the CPU
   (``tests/fixtures/sweep_reference_rerun.json``; the committed rows'
   float sums were written in another environment), losses, accuracy,
   tok/s and samples side by side, and each cell's kernels launched.  Then
   full-width yi-6b served at phase ``serve``'s configuration with 4
   requests through ``execute_cell`` (K3/K4/K5 exactly ``expected_launches``
   times its prefills and decode steps), and K3 on int16 codes at the
   12-bit cell's shapes against its plain version.

10. roofline: the port's dry run (``Session.run_dryrun``,
    ``repro_torch.roofline``) of each main path phases profile and train
    measure, at their spec, policy and shape (yi-6b's decode step and 4 x
    128 prefill, olmoe-1b-7b's and seamless-m4t's decode steps, the 8-layer
    yi-6b trainer step on 4x1), with K1-K5 counted as nodes: compute,
    memory and collective seconds a device on the H100, the bound of the
    step as the card runs it, the measured device ms and the share; the
    trainer step's trace high-water mark beside ``max_memory_allocated``;
    smoke cells of each kind recorded alike on fake CPU and fake CUDA
    tensors; yi-6b's full-width train, prefill and decode cells traced on
    1x1 with nothing left allocated on the card.  Every bound of phase
    kernels comes
    from ``repro_torch.roofline.count``'s cost functions.
11. analyze: the port's static analyzer (``Session.analyze``,
    ``repro_torch.analyze``) on each main path's spec, every step traced on
    fake CUDA tensors with nothing allocated: full-width yi-6b, olmoe-1b-7b
    and seamless-m4t (at 8, 4 and 6 + 6 layers) served with lazy int8
    weights (decode and prefill), and the 8-layer yi-6b trainer on 4x1 at comm 8; per path the findings
    by rule, the wire accumulator's proofs, the graphs' sizes and the
    seconds; an unallowlisted error (``analyze_torch.toml``) fails.  Then
    every shipped ``KernelSpec`` (the reference's dims and each path's)
    launched on NaN-filled outputs: the elements written must be the
    spec's coverage, the plan the launcher's, the output the plain
    version's within the reference's tolerances.  Then ``python -m
    repro_torch analyze --preset ci-tiny --workloads serve,fl-sim
    --fail-on error`` (in this process; the gate's two pod dry-run cells
    gate in the CPU tests), and the CPU tests' smoke trainer, which must find on fake
    CUDA tensors what it finds on fake CPU ones.

12. dist: the trainer with one client a process.  K2's keyed entry split at
    its pass boundary (pass 1 alone, pass 2 given the scales and a Philox
    stream offset) composed over 4 rows against the one-call entry on the
    card, bit-equal at the trainer's wire and at 4 x 4096 x 11008 (int16),
    with NaN/Inf, each pass against its plain version and timed beside its
    bound.  Then ``torch.distributed.run`` starts 4 ranks sharing the card
    over gloo (``repro_torch.launch.mesh.init_distributed``, share-device):
    full-width yi-6b cut to 2 layers on a 4x1 mesh, batch 2 a client,
    sequence 512, 8-bit weights, comm 8 (int16 codes widened to int32 on the
    wire): 1 ``train`` round (checkpointed; cut from 2 for the time limit)
    and 1 ``fl-orchestrate``
    round (unified_q); each rank prints per step its K1 inline and K2
    pass-1/pass-2 launches (30, 1, 1), the collectives it issued by kind and
    bytes, those the transport staged through the host, the step's span on
    the card's clock and its peak memory.  The same spec as one process
    (the loop) from the same init and keys must give the 4-rank run's
    parameters after the first step (read back through the checkpoint):
    the wire leaves bit-equal, the FSDP leaves within rtol 1e-6 of each
    leaf's largest magnitude, the loss within 1e-6.  Last, one rank over NCCL (mesh 1x1) trains a round.
13. serve_dist: batch-sharded serving (``Session.serve`` on a ``Dx1`` mesh)
    at phase serve's yi-6b configuration.  One process, 4x1, full width,
    depth cut to ``SERVE_DIST_LOOP_LAYERS`` (8 of 32) for the time limit: 4
    data shards of one slot, each with its own page pool, run one
    after another on the card; admitted and completed 8 of 8, K3, K4 and K5
    launched exactly ``expected_launches`` a shard's prefill and decode step
    times the shard calls the session made, tok/s, host ms a step, peak.
    Then ``torch.distributed.run`` starts 4 ranks sharing the card over gloo,
    one shard each, full width cut to 2 layers, max_new
    ``SERVE_DIST_RANKS_MAX_NEW`` (8, cut from 16 for the time limit):
    every rank's
    sampled tokens and ``ServeStats`` (clocks apart) must equal the
    one-process 4x1 loop's at 2 layers bit for bit; each rank's collectives
    must be one uint8 all-gather a use of each FSDP leaf and one int32
    all-gather of the shards' tokens a prefill or decode step; each rank
    prints its launches, collectives by kind, calls and bytes, staged
    collectives, host ms a step, tok/s and peak.  Last, one rank over NCCL
    at 1x1, 2 layers (``DIST_LAYERS``, cut from full depth for the time
    limit), max_new ``SERVE_DIST_RANKS_MAX_NEW``, whose tokens and stats must equal the plain 1x1
    serve's.

14. serve_tp: tensor-parallel serving (``Session.serve`` on a ``1x4`` mesh,
    one model shard a rank).  ``torch.distributed.run`` starts 4 ranks of
    this script sharing the card over gloo (NCCL refuses two ranks on one
    GPU), once for this phase and the next (``TP_PHASES``: each phase's
    part runs in the same processes, so they start and warm up once; a
    rank's failure names the phase whose part failed).  yi-6b at full width
    at phase serve's configuration (max_new 16), depth cut to
    ``SERVE_TP_YI_LAYERS`` (8 of 32) for the time limit, its 4 KV heads
    split (paged, K5), then glm4-9b at full width, depth cut to
    ``SERVE_TP_GLM_LAYERS`` (8 of 40) for the time limit, max_new 16, its 2
    KV heads replicated: the sequence-parallel cache, served contiguous as
    the driver does by default.  Every rank's tokens and ``ServeStats``
    (clocks apart) equal; K3, K4 and K5 launched exactly
    ``expected_launches`` a pass on every rank; a rank's model-group
    collectives exactly ``tp_collectives``' by kind, dtype, calls and bytes
    (the row-parallel sums, the pick's max and min, the sequence-parallel
    merge); nothing staged; every K3, K4 and K5 launch shape one that phase
    kernels holds (``_held_shapes``); tok/s, host ms a step and peak a rank.
    Then the step-level runs (``_tp_steps``) at full width, 4 layers, f32:
    yi-6b and glm4-9b on the contiguous cache, the 4 shards' gathered logits
    (a prefill and 4 decode steps) within ``SERVE_TP_1X1_TOL`` of the same
    seed's 1x1 model through the plain versions (rank 0 runs it); glm4-9b
    also paged with per-shard page tables: the gathered view equals the
    contiguous cache bit for bit, K5 on each rank's pool with the partials
    merged within ``SERVE_TP_PAGED_RTOL`` of the logits' largest magnitude;
    a slot inside shard 0's positions (the other shards' K5 at local length
    0) and one crossing ``s_max / 4``.
15. serve_tp_families: tensor-parallel serving of the SSM, hybrid, VLM and
    enc-dec families on the same 4 ranks, checked as phase serve_tp
    (``phase_tp``; ``tp_collectives`` counts each family's sums):
    full-width mamba2-780m at 8 of 48 layers (contiguous; its prefill a pass
    of collectives a prompt token), seamless-m4t at 4 + 4 of 24 + 24 layers
    and llama-3.2-vision at phase serve's 2 periods (both paged, their KV
    heads split; the cross K/V split with them, the VLM's adapter whole),
    and jamba at its smoke size (one KV head and one expert a shard), K3
    launches at the shard's expert count.  Then the step-level runs at full
    width in f32 (``SERVE_TP_FAMILY_STEPS``): seamless-m4t at 2 + 2 layers
    and llama-3.2-vision at one period (cross gates 0.5), paged through K5,
    and mamba2 at 2 layers, each within ``SERVE_TP_1X1_TOL`` of the same
    seed's 1x1 model through the plain versions; mamba2's 1x1 model takes
    its gated norm in 4 groups of channels (``grouped_gated_norm``: under
    tp the norm is over a shard's channels, the reference's semantics).
    Each tp phase prints the seconds of its ranks' part.
16. train_tp: the trainer under tensor parallelism (``Session.run_train``
    on ``1x4`` and on ``2x2``, one mesh device a rank) on the same 4 ranks:
    full-width yi-6b cut to 2 of 32 layers, batch 2 a client, sequence 512,
    8-bit weights, sequence parallelism and remat on, 3 ``train`` rounds
    each, 2x2 at comm 8 (K2's split wire over the batch group).  Every
    rank's losses equal; per round K1 and K2 launches exactly
    ``train_tp_launches`` and both groups' collectives exactly
    ``train_tp_collectives`` by kind, dtype, calls and bytes (the model
    group's sequence-parallel gathers and reduce-scatters, forward, backward
    and the remat reruns, the cross-entropy's max and sums, the replicated
    leaves' one sum; the batch group's FSDP gathers, the wire, the metrics);
    nothing staged; host ms, span on the card's clock and peak a round and
    rank.  Then the step level in f32 at 32-bit weights
    (``TRAIN_TP_STEPS``): yi-6b and mamba2-780m at full width, 2 layers, one
    step on 1x4, the slices joined, every leaf's update within
    ``TRAIN_TP_1X1_TOL`` of the same seed's 1x1 step through the plain
    versions (mamba2's gated norm in 4 groups).  Phase kernels holds K1's
    inline entry at every weight slice these ranks quantize and K2's split
    passes at a rank's wire row (``check_sr_tp_shapes``).
17. roofline_pod: the pod meshes' dry run (``Session.run_dryrun`` on a mesh
    with a model axis: one traced device, its model group a stand-in, no
    process group) on fake CUDA tensors: yi-6b's full-width train_4k,
    prefill_32k and decode_32k on 16x16 and mamba2-780m's train_4k on
    2x16x16, each priced on the H100 (compute, memory, collective and
    kernel seconds, the card's bound, the collectives by kind, the trace
    time) and held to the reference's committed row (per-device FLOPs, D4
    aside, model FLOPs, the gathers' and reduce-scatters' bytes), nothing
    left allocated on the card; smoke cells of each kind on 2x2 recorded
    alike on fake CPU and fake CUDA tensors; then the 1x4 steps phases
    serve_tp and train_tp run on real ranks (yi-6b's decode step and
    cached prefill, lazy int8, flash, 16-token pages; the 2-layer 8-bit
    train step), each traced device's model group issuing exactly what
    ``tp_collectives`` / ``train_tp_collectives`` predict for one pass or
    step, and every K1/K3/K4/K5 shape these traces record one phase
    kernels holds.

Each phase prints its own time.  The last two lines are the kernel table
and ``{"ok": true, "device": ...}``.
``--phases`` runs a subset (for iterating on one kernel); phase ``sweep``,
run only when named, times K3 at yi-6b's projections under the tile plans
near the one ``quant_matmul.plan`` picks (and the ragged path at the
unembeds' and ``w_dt``'s shapes under each tile and split), phase
``decode_sweep`` times K5
at its rows' shapes under every split of the page axis, and phase
``attn_sweep`` times K4 under every tile its path takes: the wgmma path at
the main path's, gemma-7b's, the S 513 and two head-dim-16 rows, the split
path at the main f32 row, S 513 (causal and not) and head dims 16 and 256.
Phase ``grids_all`` reruns every cell of the fl, wire and serve presets
(``--presets``) into ``--store-dir``, each row held as in phase ``grids``.
Phase ``roofline_all`` runs every ``roofline-all-archs`` pod cell through
``SweepRunner`` into ``--store-dir`` (resumable) beside the reference's
committed rows, then traces the other nine archs' full-width cells on 1x1
(~25 min).
Phase ``train_profile`` profiles rounds 1-2 of the ``train`` run alone
(device ms by family, the uniform-drawing kernels, host syncs); with
``--src=DIR`` it imports the port from another checkout (a parent commit),
so two trees compare in one call.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: ``--src=DIR`` imports the port from another checkout's ``src`` (phase
#: ``train_profile`` of a parent commit, in the same call as this one's)
SRC = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--src=")),
           os.path.join(ROOT, "src"))
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.kernels import sr_quant as sq  # noqa: E402
from repro_torch.roofline import H100_SXM, count  # noqa: E402

KERNELS = {
    "sr_quant": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                     replaces="src/repro/kernels/sr_quant.py:59"),
    "sr_quant_inline": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                            replaces="src/repro/kernels/sr_quant.py:59"),
    "sr_quant_keyed": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                           replaces="src/repro/kernels/sr_quant.py:59"),
    "sr_pack": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                    replaces="src/repro/kernels/sr_quant.py:72"),
    "sr_pack_keyed": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                          replaces="src/repro/kernels/sr_quant.py:72"),
    "sr_pack_keyed_scales": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                                 replaces="src/repro/kernels/sr_quant.py:72"),
    "sr_pack_keyed_scaled": dict(route="cuda", source="src/repro_torch/csrc/sr_quant.cu",
                                 replaces="src/repro/kernels/sr_quant.py:72"),
    "quant_matmul": dict(route="cuda", source="src/repro_torch/csrc/quant_matmul.cu",
                         replaces="src/repro/kernels/quant_matmul.py:83"),
    "flash_attention": dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:106"),
    "flash_decode": dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:237"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(cost) -> tuple[float, str]:
    """A kernel call's bound on the H100 from its cost function
    (``repro_torch.roofline.count``): ``(ms, "bytes" or "operations")``."""
    s, by = cost.bound_s(H100_SXM)
    return s * 1e3, by


def time_ms(fn, arg_sets, iters: int = 10, warmup: int = 2, replays: int = 3) -> float:
    """Mean device time of ``fn`` per call, rotating over ``arg_sets``.

    The ``iters`` calls are captured once in a CUDA graph and replayed, so
    the host's per-call overhead (argument checks, the ctypes call) cannot
    leave the card idle between launches and inflate a short kernel's time.
    """
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()                          # warm: first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def time_events_ms(fn, args, iters: int = 10, warmup: int = 2) -> float:
    """Mean time per call of ``fn(*args)`` between CUDA events, host work
    and host stalls included (for call chains a graph cannot capture)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_errs(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp_min(1e-6)).max())


# --------------------------------------------------------------------- phases
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return {"kind": kind, "smi": smi}


def _demangle(names: list) -> list:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, subprocess.CalledProcessError):
        return names


def _sass_dump(lib_path: str) -> str:
    """The built library's SASS (cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout


def _sass_counts(sass: str, prefix: str, opcodes: tuple) -> dict:
    """Per kernel whose (mangled) name holds ``prefix``: how many SASS
    instructions of ``sass`` (:func:`_sass_dump`) start with each of
    ``opcodes``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if prefix in fn:
                counts[fn] = dict.fromkeys(opcodes, 0)
            continue
        if fn in counts and "*/" in line:
            op = line.split("*/", 1)[1].strip().split(" ")[0].lstrip("@!P0123456789 ")
            for o in opcodes:
                if op.startswith(o):
                    counts[fn][o] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def _ptxas_report(log: str) -> dict:
    """Per kernel (demangled): ptxas's report lines and its spill bytes."""
    report, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            report[entry] = {"lines": [], "spill_bytes": 0}
        elif entry and ("registers" in line or "spill" in line):
            report[entry]["lines"].append(line.split(":", 1)[-1].strip())
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spills:
                report[entry]["spill_bytes"] += int(spills[1]) + int(spills[2])
            stack = re.search(r"(\d+) bytes stack frame", line)
            if stack:
                report[entry]["stack_bytes"] = int(stack[1])
    return dict(zip(_demangle(list(report)), report.values()))


def phase_build() -> None:
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    info = _build.build_info()
    print(f"build: {time.time() - t0:.2f}s (nvcc {info.get('seconds', 0.0):.2f}s, every "
          "source in parallel; per file below)")
    log = info.get("log", "")
    for line in log.splitlines():
        if line.startswith("=="):
            print("  " + line.strip())
    # the ptxas report: registers, spills and shared memory per kernel
    report = _ptxas_report(log)
    for entry, r in report.items():
        for line in r["lines"]:
            print(f"  {entry[:90]}: {line}")
    # K5's kernels and every K4 instance keep their accumulators in registers
    k4_kernels = ("flash_attention_wgmma", "flash_attention_split")
    must_not_spill = [e for e in report
                      if "flash_decode_split" in e or any(k in e for k in k4_kernels)]
    # K5: 2 pool types x 5 head dims x 4 query groups; K4: the tiles of each
    # path at each head dim
    n_fw = sum(map(len, fa.ATTN_TILES.values()))
    n_fs = sum(map(len, fa.ATTN_SPLIT_TILES.values()))
    assert len(must_not_spill) == 40 + n_fw + n_fs, must_not_spill
    # the keyed entries' passes read their by-value table from the constant
    # bank: no stack frame (a local copy of the table) and no spills.  Pass
    # 1: K1's at the inline entry's one-leaf table and the segment table,
    # K2's; K1's pass 2: f32 and bf16 out at one leaf (the inline entry), f32
    # at the segment table; K2's pass 2 at three code types
    keyed = [e for e in report if any(k in e for k in ("seg_absmax_kernel",
                                                        "sr_quant_keyed_kernel",
                                                        "sr_pack_keyed_kernel"))]
    assert len(keyed) == 9, keyed
    must_not_spill += keyed
    stacked = {e: report[e].get("stack_bytes") for e in keyed if report[e].get("stack_bytes")}
    assert not stacked, f"stack frames: {stacked}"
    # K3's ragged path: 3 accumulator heights x 2 x types x 2 code types
    ragged = [e for e in report if "qmm_ragged" in e]
    assert len(ragged) == 12, ragged
    must_not_spill += ragged
    spilled = {e: report[e]["spill_bytes"] for e in must_not_spill if report[e]["spill_bytes"]}
    assert not spilled, f"spills: {spilled}"
    # no K4 instance has its wgmma serialised by ptxas (a branch around
    # wgmma, or an accumulator touched while in flight)
    serialised = [line for line in log.splitlines()
                  if "C7518" in line and any(k in line for k in k4_kernels)]
    assert not serialised, serialised
    # K3's and K4's paths as built: K3's prefill path and every K4 instance
    # run wgmma and load through TMA, K4 stores through TMA; K3's ragged
    # path loads without TMA; no K3, K4 or K5 kernel has a global atomic
    sass = _sass_dump(str(lib_path))
    counts = _sass_counts(sass, "qmm_", ("HGMMA", "UTMALDG", "RED", "ATOMG"))
    k4 = {fn: c for k in k4_kernels for fn, c in _sass_counts(
        sass, k, ("HGMMA", "UTMALDG", "UTMASTG", "RED", "ATOMG")).items()}
    k5 = _sass_counts(sass, "flash_decode", ("RED", "ATOMG"))
    for fn, c in {**counts, **k4, **k5}.items():
        print(f"  sass {fn[:90]}: {c}")
    wg = [c for fn, c in counts.items() if "qmm_wgmma" in fn]
    assert wg and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in wg), counts
    rg = [c for fn, c in counts.items() if "qmm_ragged" in fn]
    assert len(rg) == 12 and all(c["UTMALDG"] == 0 for c in rg), counts
    fw = [c for fn, c in k4.items() if "flash_attention_wgmma" in fn]
    fs = [c for fn, c in k4.items() if "flash_attention_split" in fn]
    assert (len(fw), len(fs)) == (n_fw, n_fs), k4
    assert all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0
               for c in fw + fs), k4
    assert len(k5) == 40, k5
    assert all(c["RED"] == 0 and c["ATOMG"] == 0
               for c in (*counts.values(), *k4.values(), *k5.values())), (counts, k4, k5)


def _check(name, got, want, rtol, atol):
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    except AssertionError as e:
        raise AssertionError(f"{name}: kernel disagrees with its plain version\n{e}") from None


def check_quant_matmul(table: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000),
              (1000, 300)]
    for code_dtype, lim in ((torch.int8, 127), (torch.int16, 32767)):
        for K, N in shapes:
            codes = torch.randint(-lim, lim + 1, (K, N), generator=gen, device="cuda",
                                  dtype=torch.int32).to(code_dtype)
            scale = torch.tensor(2.0 / math.sqrt(K) / lim, device="cuda")
            # enough distinct weight copies that each timed launch finds its
            # weight outside the 50 MB L2, as a decode step does
            n_copies = max(1, min(16, math.ceil(120e6 / codes.nbytes)))
            copies = [codes] + [codes.clone() for _ in range(n_copies - 1)]
            for x_dtype in (torch.float32, torch.bfloat16):
                # the library's weight, dequantized, in as many copies as the
                # codes, so that it too streams from device memory
                w_lib = (codes.float() * scale).to(x_dtype)
                w_libs = [w_lib] + [w_lib.clone() for _ in range(n_copies - 1)]
                for M in (4, 37, 256, 512):
                    x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
                    got = qm.quant_matmul_cuda(x, codes, scale)
                    again = qm.quant_matmul_cuda(x, codes, scale)
                    want = qm.quant_matmul_plain(x, codes, scale)
                    torch.cuda.synchronize()
                    rtol, atol = (1e-4, 1e-3) if x_dtype == torch.float32 else (2e-2, 1e-2)
                    case = f"quant_matmul M={M} K={K} N={N} x={x_dtype} codes={code_dtype}"
                    _check(case, got, want, rtol, atol)
                    # deterministic: a fixed order of every sum, no atomics
                    if not torch.equal(got, again):
                        raise AssertionError(f"{case}: two launches on identical inputs differ")
                    abs_e, rel_e = max_errs(got, want)
                    sets = [(x, c, scale) for c in copies]
                    k_ms = time_ms(qm.quant_matmul_cuda, sets)
                    p_ms = time_ms(qm.quant_matmul_plain, sets[:1], iters=3, warmup=1)
                    l_ms = time_ms(torch.matmul, [(x, w) for w in w_libs])
                    b_ms, b_by = bound_ms(count.quant_matmul_cost(M, K, N, x_dtype,
                                                                  code_dtype))
                    p = qm.plan(M, K, N, x_dtype, code_dtype)
                    row = dict(kernel="quant_matmul", M=M, K=K, N=N, x=str(x_dtype),
                               codes=str(code_dtype), plan=list(p), max_abs_err=abs_e,
                               max_rel_err=rel_e, kernel_ms=k_ms,
                               earlier_ms=earlier_k3_ms(p, sets), plain_ms=p_ms,
                               library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
                    emit(row)
                    if (M, K, N, x_dtype, code_dtype) == (4, 4096, 11008, torch.bfloat16,
                                                          torch.int8):
                        table["quant_matmul"] = row
            del copies, codes, w_lib, w_libs


#: K3's ragged path at its edges (untimed): every M <= 16 height, widths
#: under one 16-byte load and an odd one, K under a stage and over one;
#: f32 and bf16 x, int8 and int16 codes
RAGGED_EDGE_M = (1, 3, 4, 13, 16)
RAGGED_EDGE_N = (1, 2, 12, 301)
RAGGED_EDGE_K = (7, 1001, 1536)
#: where the operands lie: fresh tensors; one element into a flat buffer (a
#: sliced activation, a packed leaf's view); at the end of a buffer of whole
#: 512-byte blocks
RAGGED_PLACES = ("fresh", "one element in", "at the end")


def _placed(t: torch.Tensor, place: str) -> torch.Tensor:
    n = t.numel()
    if place == "fresh":
        return t
    if place == "one element in":
        flat = torch.empty(n + 1, dtype=t.dtype, device=t.device)
        out = flat[1:]
    else:
        total = -(-(n * t.element_size() + 16) // 512) * 512 // t.element_size()
        flat = torch.empty(total, dtype=t.dtype, device=t.device)
        out = flat[total - n:]
    out.copy_(t.reshape(-1))
    return out.view(t.shape)


def check_quant_matmul_ragged() -> None:
    """K3's ragged path at every edge case (``RAGGED_EDGE_*`` x dtypes x
    ``RAGGED_PLACES``), under the plan's tile and, where K passes 1,000,
    also under the widest tile with K unsplit, so that the stage ring wraps
    and x streams in several chunks: the plan asserted (ragged), the
    launcher's output NaN-filled before the launch (an element it never
    writes stays NaN), within K3's tolerances of the plain version (f32
    1e-4 / 1e-3, bf16 2e-2 / 1e-2), two launches bit-equal.  Untimed."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    n_cases = 0
    t0 = time.time()
    for M, N, K, x_dtype, code_dtype, place in itertools.product(
            RAGGED_EDGE_M, RAGGED_EDGE_N, RAGGED_EDGE_K, (torch.float32, torch.bfloat16),
            (torch.int8, torch.int16), RAGGED_PLACES):
        lim = 127 if code_dtype == torch.int8 else 2047
        codes = _placed(torch.randint(-lim, lim + 1, (K, N), generator=gen, device="cuda",
                                      dtype=torch.int32).to(code_dtype), place)
        x = _placed(torch.randn((M, K), generator=gen, device="cuda").to(x_dtype), place)
        scale = torch.tensor(2.0 / math.sqrt(K) / lim, device="cuda")
        case = (f"quant_matmul ragged M={M} K={K} N={N} x={x_dtype} codes={code_dtype} "
                f"operands {place}")
        p = qm.plan(M, K, N, x_dtype, code_dtype, _build.sm_count(x.device),
                    aligned=x.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0)
        assert p.path == "ragged", (case, p)
        want = qm.quant_matmul_plain(x, codes, scale)
        rtol, atol = (1e-4, 1e-3) if x_dtype == torch.float32 else (2e-2, 1e-2)
        wide = qm.Plan("ragged", p.tile_m, 32 * (64 // p.tile_m), 1)
        for tp in (p, wide) if K > 1000 else (p,):
            got = _nan_filled_launch(lambda: qm.quant_matmul_cuda(x, codes, scale, tp))
            again = _nan_filled_launch(lambda: qm.quant_matmul_cuda(x, codes, scale, tp))
            torch.cuda.synchronize()
            if torch.isnan(got).any():
                raise AssertionError(f"{case} {tuple(tp)}: {int(torch.isnan(got).sum())} "
                                     "output elements never written")
            _check(f"{case} {tuple(tp)}", got, want, rtol, atol)
            if not torch.equal(got, again):
                raise AssertionError(f"{case} {tuple(tp)}: two launches on identical inputs "
                                     "differ")
            n_cases += 1
    print(f"quant_matmul ragged: {n_cases} edge cases (M {RAGGED_EDGE_M}, N {RAGGED_EDGE_N}, "
          f"K {RAGGED_EDGE_K}, f32/bf16 x, int8/int16 codes, operands "
          f"{', '.join(RAGGED_PLACES)}; the plan's tile, and K unsplit over the widest) "
          f"written whole, within tolerance, repeats bit-equal, in {time.time() - t0:.1f} s")


def phase_sweep(dev: dict) -> None:
    """K3 at yi-6b's projections under each tile plan the kernels take near
    the one ``quant_matmul.plan`` picks: the measurements behind the plan's
    choices (decode: ~1.5 blocks an SM; prefill: ``WGMMA_TILES``); then the
    ragged path at the decode shapes TMA cannot address under each tile and
    split (its plan's wave estimate)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for K, N in ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000)):
        codes = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
        scale = torch.tensor(1.0 / math.sqrt(K) / 127, device="cuda")
        n_copies = max(1, min(16, math.ceil(120e6 / codes.nbytes)))
        copies = [codes] + [codes.clone() for _ in range(n_copies - 1)]
        for M in (4, 37, 256, 512):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            chosen = qm.plan(M, K, N, x.dtype, codes.dtype)
            if M <= 16:
                cpl = 64 // chosen.tile_m
                plans = [qm.Plan("cluster", chosen.tile_m, lanes * cpl, split)
                         for lanes in (32, 16, 8, 4, 2, 1) for split in range(1, 9)]
                plans = [p for p in plans if 100 <= p.blocks(M, N) <= 300]
            else:
                plans = [qm.Plan("wgmma", bm, bn, 1) for bm, bn in qm.WGMMA_TILES
                         if M > 64 or bm == 64]
            ms = {}
            for p in dict.fromkeys([chosen] + plans):
                def run(x, c, s, p=p):
                    return qm.quant_matmul_cuda(x, c, s, tile_plan=p)
                # key tile_m/tile_n/split
                ms["/".join(map(str, p[1:]))] = time_ms(run, [(x, c, scale) for c in copies])
            emit({"sweep": {"M": M, "K": K, "N": N, "card": dev["smi"],
                            "chosen": list(chosen), "ms": ms}})
        del copies, codes
    # the ragged path at the decode shapes TMA cannot address (M 4, bf16 x):
    # seamless-m4t's unembed and a shard's, mamba2's and a shard's, the
    # shard's w_dt; every tile and split the launcher takes up to 2,000 blocks
    for K, N in ((1024, 256206), (1024, 64052), (1536, 50280), (1536, 12570), (1536, 12)):
        codes = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
        scale = torch.tensor(1.0 / math.sqrt(K) / 127, device="cuda")
        n_copies = max(1, min(16, math.ceil(120e6 / codes.nbytes)))
        copies = [codes] + [codes.clone() for _ in range(n_copies - 1)]
        x = torch.randn((4, K), generator=gen, device="cuda").to(torch.bfloat16)
        chosen = qm.plan(4, K, N, x.dtype, codes.dtype)
        plans = [qm.Plan("ragged", 4, lanes * 16, split) for lanes in (32, 16, 8, 4, 2, 1)
                 for split in range(1, min(8, K // 64) + 1)]
        plans = [p for p in plans if p.blocks(4, N) <= 2000
                 and (p.tile_n // 2 < N or p.tile_n == 16)]
        ms = {}
        for p in dict.fromkeys([chosen] + plans):
            def run(x, c, s, p=p):
                return qm.quant_matmul_cuda(x, c, s, tile_plan=p)
            ms["/".join(map(str, p[1:]))] = time_ms(run, [(x, c, scale) for c in copies])
        emit({"sweep": {"M": 4, "K": K, "N": N, "card": dev["smi"], "chosen": list(chosen),
                        "ms": ms}})
        del copies, codes


def sdpa_ms(q, k, v, causal: bool) -> tuple[float, str]:
    """The yardstick: one fused ``scaled_dot_product_attention`` call on
    4-D views ``(1, BH, S, D)`` of the kernel's own tensors (the fused
    backends take only 4-D inputs), pinned to flash attention for bf16 and
    to the memory-efficient kernel for f32 (flash takes no f32).  A shape
    the pinned backend refuses is timed under the backend SDPA picks on its
    own, and the name says so.  Returns (ms, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))

    def call(a, b, c, cz):
        return torch.nn.functional.scaled_dot_product_attention(a, b, c, is_causal=cz)

    pinned = (SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16
              else SDPBackend.EFFICIENT_ATTENTION)
    try:
        with sdpa_kernel(pinned):
            call(q4, k4, v4, causal)
            torch.cuda.synchronize()
            return time_ms(call, [(q4, k4, v4, causal)]), pinned.name
    except RuntimeError:
        chosen = SDPBackend(torch._fused_sdp_choice(q4, k4, v4, None, 0.0, causal)).name
        return time_ms(call, [(q4, k4, v4, causal)]), f"{chosen} ({pinned.name} refused)"


#: K4's rows: (BH, D, S, dtypes).  BH 128 (yi-6b's 32 heads x 4 slots) at S
#: 100, 128 and 513: yi-6b's head dim 128 and the smoke configs' 16 in f32
#: and bf16, 32 too, 64 in f32 (bf16 at S 128); gemma-7b's prefill (16 heads
#: x 4 slots, D 256) in f32 at each S and in bf16 at S 128; the smoke
#: serve's prefill (4 heads x 4 slots, D 16) at a 16-token bucket and a
#: ragged 11, where one key tile is both the first and the ragged one and
#: most of the 64 query rows lie past S; seamless-m4t's encoder (16 heads x 4
#: slots over 256 frames, D 64, non-causal: bf16 as served, f32 as phase
#: consistency runs it) and llama-3.2-vision's prefill (64 heads x 4 slots
#: at a 64-token bucket, D 128, causal); yi-6b as one data shard of phase
#: serve_dist's 4x1 mesh prefills it (32 heads x 1 slot, D 128, at its 64-
#: and 128-token buckets, bf16), and one model shard of phase serve_tp's
#: 1x4 mesh (8 of 32 heads x 4 slots, D 128) as its serves prefill (the
#: 128-token bucket, bf16) and its step-level runs (prompts padded to 200
#: tokens, f32); one model shard of phase serve_tp_families' 1x4 mesh:
#: seamless-m4t's encoder (4 of 16 heads x 4 slots over 256 frames, D 64)
#: and llama-3.2-vision's prefill (16 of 64 heads x 4 slots at the 64-token
#: bucket, D 128), bf16 as served and f32 as the step-level runs take them.
ATTN_CASES = ([(16, 16, S, (torch.float32, torch.bfloat16)) for S in (16, 11)]
              + [(64, 64, 256, (torch.float32, torch.bfloat16)), (256, 128, 64, (torch.bfloat16,))]
              + [(128, D, S, (torch.float32, torch.bfloat16)) for D in (16, 32, 128)
                 for S in (100, 128, 513)]
              + [(128, 64, S, (torch.float32,) + ((torch.bfloat16,) if S == 128 else ()))
                 for S in (100, 128, 513)]
              + [(64, 256, S, (torch.float32,) + ((torch.bfloat16,) if S == 128 else ()))
                 for S in (100, 128, 513)]
              + [(32, 128, S, (torch.bfloat16,)) for S in (64, 128)]
              + [(32, 128, 200, (torch.float32,))]
              + [(16, 64, 256, (torch.float32, torch.bfloat16)),
                 (64, 128, 64, (torch.float32, torch.bfloat16))])
#: The path each type takes (kernels/flash_attention.plan_attention).
ATTN_PATH_OF = {torch.bfloat16: "wgmma", torch.float32: "wgmma_split"}


def check_flash_attention(table: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-4 if dtype == torch.float32 else 3e-2
        for BH, D, S, dtypes in ATTN_CASES:
            if dtype not in dtypes:
                continue
            q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            for causal in (False, True):
                got = fa.flash_attention_cuda(q, k, v, causal)
                again = fa.flash_attention_cuda(q, k, v, causal)
                want = fa.flash_attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                case = f"flash_attention BH={BH} S={S} D={D} {dtype} causal={causal}"
                _check(case, got, want, tol, tol)
                # deterministic: a fixed order of every sum, no atomics
                if not torch.equal(got, again):
                    raise AssertionError(f"{case}: two launches on identical inputs differ")
                abs_e, rel_e = max_errs(got, want)
                k_ms = time_ms(fa.flash_attention_cuda, [(q, k, v, causal)])
                p_ms = time_ms(fa.flash_attention_plain, [(q, k, v, causal)], iters=3)
                l_ms, backend = sdpa_ms(q, k, v, causal)
                p = fa.plan_attention(BH, S, D, dtype, causal, sms)
                cost = count.flash_attention_cost(BH, S, D, dtype, causal)
                b_ms, b_by = bound_ms(cost)
                # what the split path's three bf16 products cost (not the bound)
                split_ms = 3 * cost.flops / H100_SXM.peak_flops_bf16 * 1e3
                row = dict(kernel="flash_attention", BH=BH, S=S, D=D, dtype=str(dtype),
                           causal=causal, path=p.path, block_q=p.block_q, block_k=p.block_k,
                           blocks=p.blocks, max_abs_err=abs_e,
                           max_rel_err=rel_e, repeat_equal=True, kernel_ms=k_ms,
                           plain_ms=p_ms, library_ms=l_ms, library_backend=backend,
                           bound_ms=b_ms, bound_by=b_by,
                           split_products_ms=split_ms if p.path == "wgmma_split" else None,
                           speedup_vs_library=l_ms / k_ms)
                emit(row)
                assert p.path == ATTN_PATH_OF[dtype], row
                if (BH, S, D, dtype, causal) == (128, 128, 128, torch.bfloat16, True):
                    assert p.blocks >= 128, row
                    table["flash_attention"] = row
            del q, k, v


#: attn_sweep's rows (BH, S, D, causal, dtype): bf16 (the wgmma path) at the
#: main path's prefill, gemma-7b's, the long non-causal row and head dim 16;
#: f32 (the split path) at the main row, S 513 both ways, and at S 128 and
#: 513 for head dims 16, 32 and 64, and gemma-7b's 256.
ATTN_SWEEP_ROWS = ((128, 128, 128, True, torch.bfloat16), (64, 128, 256, True, torch.bfloat16),
                   (128, 513, 128, False, torch.bfloat16), (128, 128, 16, True, torch.bfloat16),
                   (128, 513, 16, False, torch.bfloat16),
                   (128, 128, 128, True, torch.float32), (128, 513, 128, False, torch.float32),
                   (128, 513, 128, True, torch.float32), (128, 128, 16, True, torch.float32),
                   (128, 513, 16, False, torch.float32), (128, 128, 32, True, torch.float32),
                   (128, 513, 32, False, torch.float32), (128, 128, 64, True, torch.float32),
                   (128, 513, 64, False, torch.float32), (64, 128, 256, True, torch.float32),
                   (64, 513, 256, False, torch.float32))


def attention_tile_plans(BH: int, S: int, D: int, dtype) -> list:
    """Every plan K4's path for ``dtype`` takes at this shape, one a tile."""
    path, tiles = (("wgmma", fa.ATTN_TILES) if dtype == torch.bfloat16
                   else ("wgmma_split", fa.ATTN_SPLIT_TILES))
    return [fa.attention_plan_for(path, BH, S, D, bq, bk) for bq, bk in tiles[D]]


def phase_attn_sweep(dev: dict) -> None:
    """K4 at each row of :data:`ATTN_SWEEP_ROWS` under every tile its path
    takes, each held to the plain version first: the measurements behind
    ``flash_attention.plan_attention``'s choice."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for BH, S, D, causal, dtype in ATTN_SWEEP_ROWS:
        q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        want = fa.flash_attention_plain(q, k, v, causal)
        chosen = fa.plan_attention(BH, S, D, dtype, causal, sms)
        tol = 2e-4 if dtype == torch.float32 else 3e-2
        ms = {}
        for p in attention_tile_plans(BH, S, D, dtype):
            tile = f"{p.block_q}/{p.block_k}"
            got = fa.flash_attention_cuda(q, k, v, causal, attn_plan=p)
            _check(f"attn_sweep BH={BH} S={S} D={D} {dtype} causal={causal} tile {tile}", got,
                   want, tol, tol)

            def run(*a, p=p):
                return fa.flash_attention_cuda(*a, attn_plan=p)
            ms[tile] = time_ms(run, [(q, k, v, causal)])
        emit({"attn_sweep": {"BH": BH, "S": S, "D": D, "causal": causal, "dtype": str(dtype),
                             "path": chosen.path, "card": dev["smi"],
                             "chosen": f"{chosen.block_q}/{chosen.block_k}",
                             "ms": ms}})
        del q, k, v


def check_attention_one_hot() -> None:
    """Where each element of q, K and V lands, through every K4 tile of both
    paths at every head dim, so at every swizzle K4 uses (bf16 rows of 32,
    64 and 128 bytes at head dims 16, 32 and 64 up; the split path's f32
    output rows of 64 and 128 bytes).  Head h of a batch carries one hot
    element of one operand at (row j_h, column d_h), spread over every row
    of a swizzle atom and every 16-byte unit; the other operands make the
    output show where it landed; each launch held to the plain version.
      V hot: q = k = 0, so row i averages v over keys <= i, and the hot 1
        appears in column d_h from row j_h on.
      K hot: every query is 16 at column d_h and key j_h is 16 there, so
        rows from j_h on attend to key j_h alone; v[j] = (j + 1) / S.
      Q hot: row j_h is 16 at column d_h and key 0 is 16 there, so row j_h
        alone attends to key 0; v as above."""
    BH, S = 64, 130
    h = torch.arange(BH, device="cuda")
    cases = 0
    worst = {}
    for D in fa.HEAD_DIMS:
        rows = (h * 37 + 1) % S
        cols = (h * 8 + h // 8) % D
        ramp = ((torch.arange(S, device="cuda", dtype=torch.float32) + 1) / S)[None, :, None]
        zeros = torch.zeros((BH, S, D), device="cuda")
        v_hot = zeros.clone()
        v_hot[h, rows, cols] = 1.0
        k_hot, q_col = zeros.clone(), zeros.clone()
        k_hot[h, rows, cols] = 16.0
        q_col[h, :, cols] = 16.0
        q_hot, k_first = zeros.clone(), zeros.clone()
        q_hot[h, rows, cols] = 16.0
        k_first[h, 0, cols] = 16.0
        v_ramp = ramp.expand(BH, S, D).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            tol = 2e-4 if dtype == torch.float32 else 3e-2
            for operand, qkv in (("V", (zeros, zeros, v_hot)), ("K", (q_col, k_hot, v_ramp)),
                                 ("Q", (q_hot, k_first, v_ramp))):
                q, k, v = (t.to(dtype) for t in qkv)
                want = fa.flash_attention_plain(q, k, v, True)
                for p in attention_tile_plans(BH, S, D, dtype):
                    got = fa.flash_attention_cuda(q, k, v, True, attn_plan=p)
                    tile = f"{p.path} {p.block_q}/{p.block_k}"
                    _check(f"one-hot {operand} D={D} {dtype} {tile}", got, want, tol, tol)
                    key = f"{p.path} D={D}"
                    worst[key] = max(worst.get(key, 0.0), max_errs(got, want)[0])
                    cases += 1
    emit({"attention_one_hot": {"launches": cases, "heads": BH, "S": S, "causal": True,
                                "max_abs_err": worst}})


def decode_case(q_dtype, pool_dtype, gen, *, KV=4, G=8, hd=128, page=16, n_pmax=16,
                lengths=(253, 60, 100, 0)):
    """Paged decode inputs (B = len(lengths) slots), by default at yi-6b's
    decode shape (KV 4, G 8, hd 128, page 16, s_max 256): slot b owns the
    pages its length needs, in a shuffled pool; slot 1 (where there is one)
    has a -1 hole inside its length; a slot of length 0 owns two pages but holds no token;
    lengths lie off the page grid."""
    B = len(lengths)
    owned = [min(n_pmax, -(-n // page)) if n else 2 for n in lengths]
    n_pool = sum(owned) + 8
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(q_dtype)
    kp = torch.randn((n_pool, page, KV, hd), generator=gen, device="cuda").to(pool_dtype)
    vp = torch.randn((n_pool, page, KV, hd), generator=gen, device="cuda").to(pool_dtype)
    perm = torch.randperm(n_pool, generator=gen, device="cuda").to(torch.int32)
    pt = torch.full((B, n_pmax), -1, dtype=torch.int32, device="cuda")
    for b, (start, n) in enumerate(zip(itertools.accumulate([0] + owned), owned)):
        pt[b, :n] = perm[start:start + n]
    if B > 1:
        pt[1, 1] = -1
    return q, kp, vp, pt, torch.tensor(lengths, dtype=torch.int32, device="cuda")


#: K5's rows: (label, decode_case keywords, (q, pool) dtypes, copies of the
#: pools the timing rotates over).  gemma-7b, glm4-9b, seamless-m4t's decoder
#: (its f32 q as phase consistency runs it) and llama-3.2-vision at s_max 256; the
#: long context at ~4,000 tokens a slot (~65 MB of f32 pages), timed over two
#: copies so that it streams from device memory rather than the 50 MB L2;
#: yi-6b's one slot as a data shard of phase serve_dist's 4x1 mesh decodes it;
#: phase serve_tp's ranks: yi-6b's one KV head a model shard (4 slots), and
#: glm4-9b's sequence shard of 64 positions (4 pages) with all 32 q heads
#: gathered (G 16), in f32 as its step-level run decodes, a slot of local
#: length 0 (no position on the shard) among them; phase serve_tp_families'
#: ranks: seamless-m4t's 4 of 16 KV heads and llama-3.2-vision's 2 of 8 (bf16
#: q as served, f32 as the step-level runs), the smoke jamba's one of 4 (f32).
DECODE_CASES = (
    [("yi-6b", {}, (qd, pd), 1) for qd in (torch.float32, torch.bfloat16)
     for pd in (torch.float32, torch.bfloat16)]
    + [("gemma-7b", dict(KV=16, G=1, hd=256), (torch.bfloat16, pd), 1)
       for pd in (torch.float32, torch.bfloat16)]
    + [("glm4-9b", dict(KV=2, G=16, hd=128), (torch.bfloat16, pd), 1)
       for pd in (torch.float32, torch.bfloat16)]
    + [("seamless-m4t", dict(KV=16, G=1, hd=64), (qd, torch.float32), 1)
       for qd in (torch.bfloat16, torch.float32)]
    + [("llama-3.2-vision", dict(KV=8, G=8, hd=128), (torch.bfloat16, torch.float32), 1)]
    + [("long context", dict(n_pmax=256, lengths=(4093, 4000, 3950, 4067)),
        (torch.bfloat16, torch.float32), 2)]
    + [("yi-6b one shard", dict(lengths=(150,)), (torch.bfloat16, torch.float32), 1)]
    + [("yi-6b one of 4 model shards", dict(KV=1, G=8, lengths=(150, 140, 131, 129)),
        (torch.bfloat16, pd), 1) for pd in (torch.float32, torch.bfloat16)]
    + [("glm4-9b one of 4 sequence shards", dict(KV=2, G=16, n_pmax=4, lengths=(24, 0, 64, 2)),
        (torch.float32, torch.float32), 1)]
    + [(f"{arch} one of 4 model shards", shape, (qd, torch.float32), 1)
       for arch, shape in (("seamless-m4t", dict(KV=4, G=1, hd=64)),
                           ("llama-3.2-vision", dict(KV=2, G=8, hd=128)))
       for qd in (torch.bfloat16, torch.float32)]
    + [("jamba smoke one of 4 model shards", dict(KV=1, G=1, hd=16),
        (torch.float32, torch.float32), 1)])


def check_flash_decode(table: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, shape, (q_dtype, pool_dtype), n_copies in DECODE_CASES:
        args = decode_case(q_dtype, pool_dtype, gen, **shape)
        acc, m, l = fa.flash_decode_cuda(*args)
        again = fa.flash_decode_cuda(*args)
        racc, rm, rl = fa.flash_decode_plain(*args)
        torch.cuda.synchronize()
        case = f"flash_decode {label} q={q_dtype} pool={pool_dtype}"
        y, ry = acc / l.clamp_min(1e-30), racc / rl.clamp_min(1e-30)
        _check(case + " acc/l", y, ry, 1e-4, 1e-4)
        _check(case + " m", m, rm, 1e-4, 1e-4)
        _check(case + " l", l, rl, 1e-4, 1e-4)
        q, kp, vp, pt, lengths = args
        for b in (lengths == 0).nonzero().flatten().tolist():
            if not (bool((m[b] == -1e30).all()) and bool((l[b] == 0).all())
                    and bool((acc[b] == 0).all())):
                raise AssertionError(f"{case}: the empty slot must give m=-1e30, l=0, acc=0")
        # deterministic: a fixed merge order, no atomics
        if not all(torch.equal(a, b) for a, b in zip((acc, m, l), again)):
            raise AssertionError(f"{case}: two launches on identical inputs differ")
        abs_e, rel_e = max_errs(y, ry)
        sets = [args] + [(q, kp.clone(), vp.clone(), pt, lengths) for _ in range(n_copies - 1)]
        k_ms = time_ms(fa.flash_decode_cuda, sets, iters=50 if n_copies == 1 else 20)
        p_ms = time_ms(fa.flash_decode_plain, sets[:1], iters=10)
        B, KV, G, hd = q.shape
        page, n_pmax = kp.shape[1], pt.shape[1]
        # the work this run's data needs: the pages each slot reads (up to
        # its length)
        tokens = count.decode_tokens(pt.tolist(), lengths.tolist(), page)
        b_ms, b_by = bound_ms(count.flash_decode_cost(B, KV, G, hd, q_dtype, pool_dtype,
                                                      n_pmax, tokens))
        p = fa.plan_decode(B, KV, G, hd, page, n_pmax, q_dtype, pool_dtype, sms)
        row = dict(kernel="flash_decode", case=label, B=B, KV=KV, G=G, hd=hd, page=page,
                   n_pmax=n_pmax, tokens=tokens, q=str(q_dtype), pool=str(pool_dtype),
                   blocks=p.blocks, split=p.split, group=p.group, smem=p.smem, sms=sms,
                   max_abs_err=abs_e, max_rel_err=rel_e, repeat_equal=True, kernel_ms=k_ms,
                   plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   bound_share=b_ms / k_ms)
        emit(row)
        if (label, q_dtype, pool_dtype) == ("yi-6b", torch.bfloat16, torch.float32):
            assert row["blocks"] >= 128, row
            table["flash_decode"] = row
        del sets, args, q, kp, vp


def phase_decode_sweep(dev: dict) -> None:
    """K5 at each decode row's shape (bf16 q, f32 pool) under every split of
    the page axis from 2 to 16 that the pages fill: the measurements behind
    ``flash_attention.plan_decode``'s rule (about two blocks an SM, at most
    12 a cluster).  Each split is held to the plain version first."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, shape, dtypes, n_copies in DECODE_CASES:
        if dtypes != (torch.bfloat16, torch.float32):
            continue
        args = decode_case(*dtypes, gen, **shape)
        q, kp, vp, pt, lengths = args
        racc, _rm, rl = fa.flash_decode_plain(*args)
        sets = [args] + [(q, kp.clone(), vp.clone(), pt, lengths) for _ in range(n_copies - 1)]
        n_pmax = pt.shape[1]
        chosen = fa.plan_decode(*q.shape, kp.shape[1], n_pmax, *dtypes)
        ms = {}
        for split in range(2, fa.MAX_CLUSTER + 1):
            per = -(-n_pmax // split)
            if -(-n_pmax // per) != split:
                continue              # the pages fill fewer ranges
            p = chosen._replace(split=split, pages_per_block=per,
                                blocks=chosen.blocks // chosen.split * split)
            acc, _m, l = fa.flash_decode_cuda(*args, decode_plan=p)
            _check(f"decode_sweep {label} split {split}", acc / l.clamp_min(1e-30),
                   racc / rl.clamp_min(1e-30), 1e-4, 1e-4)

            def run(*a, p=p):
                return fa.flash_decode_cuda(*a, decode_plan=p)
            ms[split] = time_ms(run, sets, iters=50 if n_copies == 1 else 20)
        emit({"decode_sweep": {"case": label, "card": dev["smi"], "chosen": chosen.split,
                               "ms_by_split": ms}})
        del sets, args


def _segments(sizes, C, gen, scale=0.3):
    """K1 inputs for ragged leaves of ``sizes`` and ``C`` clients."""
    from repro_torch.core.quantization import tensor_scale

    leaves = [torch.randn(n, generator=gen, device="cuda") * scale * (i + 1)
              for i, n in enumerate(sizes)]
    w = torch.cat(leaves)
    offsets = torch.tensor([0, *itertools.accumulate(sizes)], dtype=torch.int32,
                           device="cuda")
    s = torch.stack([tensor_scale(x) if x.numel() else torch.ones((), device="cuda")
                     for x in leaves])
    u = torch.rand((C, w.numel()), generator=gen, device="cuda")
    return w, offsets, s, u


def _fl_params(arch: str) -> dict:
    """The fl-sim specs' models (phase ``fl``), initialised on the card."""
    from repro_torch.models import cnn

    model = (cnn.mobilenet(width=8, n_stages=2) if arch == "mobilenet"
             else cnn.resnet(depth_blocks=(1, 1), width=8))
    return model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


def _fl_leaf_sizes(arch: str) -> list:
    from repro_torch.core.quantization import quantizable_paths

    params = _fl_params(arch)
    return [params[p].numel() for _i, p in quantizable_paths(params)]


def check_sr_quant(table: dict) -> None:
    """K1 against its plain version with atol 0: ragged segments, bits 2, 4,
    7, 8, 16, a zero step (bits 32), clipping at +-s, the single-tensor
    entry; then times at the fl-sim round shapes and two large shapes."""
    from repro_torch.core.quantization import delta_from_bits

    gen = torch.Generator(device="cuda").manual_seed(3)
    bits = torch.tensor([2, 4, 7, 8, 16, 32, 8, 4])
    delta = delta_from_bits(bits).cuda()
    for sizes in ([5, 1, 1000, 0, 33, 4099], [72, 128, 144, 256, 160, 216]):
        w, offsets, s, u = _segments(sizes, len(bits), gen)
        s[2] = s[2] * 0.5                    # a leaf whose grid ends inside its range
        got = sq.sr_quant_segments_cuda(w, offsets, s, delta, u)
        torch.cuda.synchronize()
        for label, want in (("plain on the card", sq.sr_quant_segments_plain(
                w, offsets, s, delta, u)), ("plain on the CPU", sq.sr_quant_segments_plain(
                *(t.cpu() for t in (w, offsets, s, delta, u))).cuda())):
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"sr_quant segments {sizes}: {bad} elements differ "
                                     f"from the {label}")
        if not torch.equal(got[5], w):
            raise AssertionError("sr_quant: a zero step must return w")
        raw = sq.sr_quant_segments_cuda(w, offsets, s, delta, u, ste=False)
        if not torch.equal(raw, sq.sr_quant_segments_plain(w, offsets, s, delta, u,
                                                           ste=False)):
            raise AssertionError(f"sr_quant segments {sizes} (q itself): differs from "
                                 "the plain version")
        lo, hi = int(offsets[2]), int(offsets[3])
        clipped = raw[:5, lo:hi].abs()
        if not ((clipped <= s[2]).all() and (clipped == s[2]).any()):
            raise AssertionError("sr_quant: the clip to [-s, s] did not bite")
    for bits_ in (2, 4, 7, 8, 16):
        w = torch.randn((300, 257), generator=gen, device="cuda")
        u = torch.rand(w.shape, generator=gen, device="cuda")
        got = ops.sr_quantize_fused(w, bits_, u)
        want = ops.sr_quantize_fused(w.cpu(), bits_, u.cpu()).cuda()
        if not torch.equal(got, want):
            raise AssertionError(f"sr_quantize_fused bits={bits_}: differs from the plain "
                                 "version on the CPU")
    print("sr_quant: bit-equal to the plain version in every case (atol 0)")

    d8 = delta_from_bits(torch.tensor([16, 8, 16, 16, 16, 8, 8, 16])).cuda()
    cases = [("mobilenet round", _fl_leaf_sizes("mobilenet"), 8),
             ("resnet round", _fl_leaf_sizes("resnet"), 8),
             ("1024x1024", [1024 * 1024], 1), ("4096x11008", [4096 * 11008], 1)]
    for label, sizes, C in cases:
        w, offsets, s, u = _segments(sizes, C, gen)
        d = d8[:C]
        args = (w, offsets, s, d, u)
        got = sq.sr_quant_segments_cuda(*args)
        want = sq.sr_quant_segments_plain(*args)
        torch.cuda.synchronize()
        P, L = w.numel(), len(sizes)
        b_ms, b_by = bound_ms(count.sr_quant_segments_cost(P, C, L))
        iters = 10 if P > 1e7 else 50
        row = dict(kernel="sr_quant", case=label, clients=C, leaves=L, P=P,
                   max_abs_err=float((got - want).abs().max()),
                   kernel_ms=time_ms(sq.sr_quant_segments_cuda, [args], iters=iters),
                   plain_ms=time_ms(sq.sr_quant_segments_plain, [args], iters=3),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit(row)
        if label == "mobilenet round":
            table["sr_quant"] = row


#: Random123's known answers for philox4x32-10: (counter, key, output).
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)


def _words(rows) -> torch.Tensor:
    """32-bit words as an int32 tensor (two's complement)."""
    return torch.tensor([[x - 2**32 if x >= 2**31 else x for x in r] for r in rows],
                        dtype=torch.int32)


def earlier_weight_use(w, delta, site):
    """A trainer weight use as the parent tree made it: the site's key from
    a SeedSequence, a seeded generator and ``torch.rand``, then
    ``sr_quantize`` (abs/amax/where scale, offsets built on the host, K1's
    segment entry, the STE add/sub) and ``ParamCtx``'s cast to bf16."""
    from repro_torch.core.fwq import site_key
    from repro_torch.core.quantization import sr_quantize

    gen = torch.Generator(device=w.device).manual_seed(site_key(*site))
    u = torch.rand(w.shape, generator=gen, device=w.device)
    return sr_quantize(w, delta, u).to(torch.bfloat16)


def inline_weight_use(w, delta, key):
    """The same weight use through the keyed entry (the site's key made
    once, as ``SRDraws.weight_key`` caches it)."""
    from repro_torch.core.quantization import sr_quantize_keyed

    return sr_quantize_keyed(w, delta, key, out_dtype=torch.bfloat16)


def check_sr_quant_inline(table: dict) -> None:
    """K1's inline entry against its plain version with atol 0 (on the card
    and on the CPU): the Philox known answers; bits 4, 8, 16, 32 at n 1, 3,
    4099 in f32 and bf16, an all-zero w, an unaligned base, a key above
    2^63.  Then at a 4096 x 11008 and a 4096 x 512 (wk) weight use, f32 in
    and bf16 out: the entry's time beside the parent's chain at the same
    shape, each pass's device time, the max|w| reductions PyTorch offers,
    and the bound (bytes, or Philox's integer issue)."""
    from repro_torch.core.fwq import site_key
    from repro_torch.core.quantization import delta_from_bits

    ctr = _words([c for c, _k, _w in PHILOX_KAT]).cuda()
    key = _words([k for _c, k, _w in PHILOX_KAT]).cuda()
    got = sq.philox4x32_cuda(ctr, key).cpu()
    if not torch.equal(got, _words([w for _c, _k, w in PHILOX_KAT])):
        raise AssertionError(f"philox4x32 on the card misses Random123's known answers: {got}")
    print("sr_quant_inline: Philox4x32-10 meets Random123's known answers on the card")

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(f"n {n} bits {b}", torch.randn(n, generator=gen, device="cuda") * 0.3, b)
             for n in (1, 3, 4099) for b in (4, 8, 16, 32)]
    cases.append(("all-zero w", torch.zeros(4099, device="cuda"), 8))
    buf = torch.randn(4101, generator=gen, device="cuda")
    cases.append(("unaligned base (4-byte offset)", buf[1:], 8))
    cases.append(("4096 x 512", torch.randn((4096, 512), generator=gen, device="cuda"), 8))
    n_cases = 0
    for i, (label, w, bits_) in enumerate(cases):
        d = delta_from_bits(bits_).reshape(1).cuda()
        k = 0xFEDCBA9876543210 if i % 2 else 1000003 * (i + 1)
        for od in (torch.float32, torch.bfloat16):
            got = sq.sr_quant_inline_cuda(w, d, k, od)
            torch.cuda.synchronize()
            for where, want in (
                    ("plain on the card", sq.sr_quant_inline_plain(w, d, k, od)),
                    ("plain on the CPU", sq.sr_quant_inline_plain(w.cpu(), d.cpu(), k, od)
                     .cuda())):
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"sr_quant_inline {label} {od}: {bad} elements "
                                         f"differ from the {where}")
            if bits_ == 32 and not torch.equal(got, w.to(od)):
                raise AssertionError("sr_quant_inline: bits 32 must return w")
            n_cases += 1
    print(f"sr_quant_inline: bit-equal to the plain version in all {n_cases} cases "
          "(atol 0; card and CPU)")

    for label, shape, site in (("4096x11008 (w_up)", (4096, 11008), (0, 1, 0, 11)),
                               ("4096x512 (wk)", (4096, 512), (0, 1, 0, 12))):
        w = torch.randn(shape, generator=gen, device="cuda") * 0.02
        d = delta_from_bits(8).reshape(1).cuda()
        k = 0x243F6A8885A308D3
        args = (w, d, k, torch.bfloat16)
        got = sq.sr_quant_inline_cuda(*args)
        want = sq.sr_quant_inline_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"sr_quant_inline {label}: differs from the plain version")
        n = w.numel()
        cost = count.sr_quant_inline_cost(n, torch.bfloat16)
        b_ms, b_by = bound_ms(cost)
        bytes_ms = cost.bytes / H100_SXM.hbm_bw * 1e3
        kernel_ms = time_ms(sq.sr_quant_inline_cuda, [args], iters=10 if n > 1e7 else 50)
        passes = _device_ms_by_name(lambda: sq.sr_quant_inline_cuda(*args), 10)
        absmax_ms = _pass_ms(passes, ("seg_absmax",))
        quant_ms = _pass_ms(passes, ("sr_quant_keyed",))
        wg = w.detach().clone().requires_grad_()
        earlier = _device_ms_by_name(lambda: earlier_weight_use(wg, d.reshape(()), site), 5)
        key = site_key(*site)
        entry = _device_ms_by_name(lambda: inline_weight_use(wg, d.reshape(()), key), 5)
        inf = float("inf")
        norm_ms = time_ms(lambda x: torch.linalg.vector_norm(x, inf), [(w,)])
        aminmax_ms = time_ms(torch.aminmax, [(w,)])
        row = dict(
            kernel="sr_quant_inline", case=label, n=n, bits=8, out="bfloat16",
            max_abs_err=float((got.float() - want.float()).abs().max()),
            kernel_ms=kernel_ms, bytes_ms=bytes_ms,
            philox_int_ms=cost.int_ops / H100_SXM.int32_ops * 1e3, bound_ms=b_ms, bound_by=b_by,
            share_of_bound=b_ms / kernel_ms,
            absmax_pass_ms=absmax_ms, rounding_pass_ms=quant_ms,
            absmax_tb_s=4 * n / absmax_ms / 1e9 if absmax_ms else None,
            vector_norm_inf_ms=norm_ms, vector_norm_tb_s=4 * n / norm_ms / 1e9,
            aminmax_ms=aminmax_ms, aminmax_tb_s=4 * n / aminmax_ms / 1e9,
            entry_host_ms=time_events_ms(inline_weight_use, (wg, d.reshape(()), key)),
            earlier_host_ms=time_events_ms(earlier_weight_use, (wg, d.reshape(()), site)),
            entry_device_ms=sum(r[0] for r in entry) if entry else "not measured",
            earlier_device_ms=sum(r[0] for r in earlier) if earlier else "not measured",
            earlier_kernels=[{"ms": ms, "count": c, "name": nm[:60]}
                             for ms, c, nm in earlier[:8]],
            plain_ms=time_events_ms(sq.sr_quant_inline_plain, args, iters=3, warmup=1),
            library_ms=None)
        emit(row)
        if label.startswith("4096x11008"):
            table["sr_quant_inline"] = row
        del w, wg, got, want


#: K1's inline entry at the weight slices phase train_tp's ranks quantize:
#: yi-6b's projections, embedding and unembedding on one of 4 model shards
#: (1x4) and, FSDP-gathered, on one of 2 (2x2)
TRAIN_TP_K1_SHAPES = {
    "1x4": (("wq", (4096, 1024)), ("wk/wv", (4096, 128)), ("wo", (1024, 4096)),
            ("w_up/w_gate", (4096, 2752)), ("w_down", (2752, 4096)),
            ("embed", (16000, 4096)), ("unembed", (4096, 16000))),
    "2x2": (("wq", (4096, 2048)), ("wk/wv", (4096, 256)), ("wo", (2048, 4096)),
            ("w_up/w_gate", (4096, 5504)), ("w_down", (5504, 4096)),
            ("embed", (32000, 4096)), ("unembed", (4096, 32000)))}
#: K2's split entries at one rank's row of the 2x2 run's wire (its two
#: clients: the norm scales ln1, ln2 of 2 layers and final_norm)
TRAIN_TP_WIRE_SIZES = [2 * 4096, 2 * 4096, 4096]


def check_sr_tp_shapes() -> None:
    """K1's inline entry at each weight slice of phase train_tp
    (``TRAIN_TP_K1_SHAPES``; f32 in, bf16 out, 8 bits) and K2's two split
    passes at one rank's row of its 2x2 wire (``TRAIN_TP_WIRE_SIZES``,
    int16 codes): each bit-equal to its plain version, timed beside its
    bound and its plain version."""
    from repro_torch.core.quantization import delta_from_bits

    gen = torch.Generator(device="cuda").manual_seed(31)
    d = delta_from_bits(8).reshape(1).cuda()
    k = 0x13198A2E03707344
    for mesh, shapes in TRAIN_TP_K1_SHAPES.items():
        for name, shape in shapes:
            w = torch.randn(shape, generator=gen, device="cuda") * 0.02
            args = (w, d, k, torch.bfloat16)
            got = sq.sr_quant_inline_cuda(*args)
            want = sq.sr_quant_inline_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"sr_quant_inline at train_tp {mesh} {name} {shape}: "
                                     f"{int((got != want).sum())} elements differ from the "
                                     "plain version")
            b_ms, b_by = bound_ms(count.sr_quant_inline_cost(w.numel(), torch.bfloat16))
            kernel_ms = time_ms(sq.sr_quant_inline_cuda, [args], iters=20)
            emit(dict(kernel="sr_quant_inline", case=f"train_tp {mesh} {name}",
                      shape=list(shape), n=w.numel(), bits=8, out="bfloat16", max_abs_err=0.0,
                      kernel_ms=kernel_ms, bound_ms=b_ms, bound_by=b_by,
                      share_of_bound=b_ms / kernel_ms,
                      plain_ms=time_events_ms(sq.sr_quant_inline_plain, args, iters=3,
                                              warmup=1), library_ms=None))
            del w, got, want
    leaves = _grads(TRAIN_TP_WIRE_SIZES, 2, gen, scale=0.05)
    row = [[leaf[1]] for leaf in leaves]
    f_c, b_c = sq.sr_pack_keyed_scales_cuda(row)
    f_p, b_p = sq.sr_pack_keyed_scales_plain(row)
    smax = torch.stack([f_c[0], f_c[0] * 1.25]).amax(dim=0)
    scaled = (row, smax, f_c, k, 255, torch.int16, 1)
    q_c, q_p = sq.sr_pack_keyed_scaled_cuda(*scaled), sq.sr_pack_keyed_scaled_plain(*scaled)
    torch.cuda.synchronize()
    for name, a, b in (("pass 1 fmax", f_c, f_p), ("pass 1 count", b_c, b_p),
                       ("pass 2 codes", q_c[0], q_p[0]), ("pass 2 pitch", q_c[1], q_p[1])):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"sr_pack_keyed split at the train_tp wire row: {name} differs "
                                 "from the plain version")
    P = sum(TRAIN_TP_WIRE_SIZES)
    for name, fn, plain, args, cost in (
            ("sr_pack_keyed_scales", sq.sr_pack_keyed_scales_cuda,
             sq.sr_pack_keyed_scales_plain, (row,),
             count.sr_pack_keyed_scales_cost(P, 1, len(TRAIN_TP_WIRE_SIZES))),
            ("sr_pack_keyed_scaled", sq.sr_pack_keyed_scaled_cuda,
             sq.sr_pack_keyed_scaled_plain, scaled,
             count.sr_pack_keyed_scaled_cost(P, 1, len(TRAIN_TP_WIRE_SIZES), torch.int16))):
        b_ms, b_by = bound_ms(cost)
        kernel_ms = time_ms(fn, [args], iters=50)
        emit(dict(kernel=name, case="train_tp 2x2 wire, one rank's row", rows=1,
                  leaves=len(TRAIN_TP_WIRE_SIZES), P=P, bits=8, codes="int16", max_abs_err=0.0,
                  kernel_ms=kernel_ms, bound_ms=b_ms, bound_by=b_by,
                  share_of_bound=b_ms / kernel_ms,
                  plain_ms=time_events_ms(plain, args, iters=3, warmup=1), library_ms=None))
    print("sr_quant_inline and the split sr_pack_keyed at phase train_tp's shapes: bit-equal to "
          f"their plain versions ({sum(map(len, TRAIN_TP_K1_SHAPES.values()))} weight slices, "
          "one wire row)")


#: The wire leaves of a yi-6b train step at 8 layers on a 4x1 mesh: the
#: reference FSDP-shards every matrix, so only the norm scales (ln1, ln2 of
#: every layer, final_norm) cross the SR wire.
TRAIN_WIRE_SIZES = [8 * 4096, 8 * 4096, 4096]


def check_sr_pack(table: dict) -> None:
    """K2 against its plain version with atol 0 at the train step's wire
    shape and three large shapes, for bits 4, 7 and 8 with a pitch that
    makes the clip bite; then times at each case's own bits."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [("train step wire, int16", TRAIN_WIRE_SIZES, 4, torch.int16, 8),
             ("1024x1024, int8", [1024 * 1024], 1, torch.int8, 7),
             ("4096x11008, int8", [4096 * 11008], 1, torch.int8, 7),
             ("4096x11008, int16", [4096 * 11008], 1, torch.int16, 8)]
    for label, sizes, C, dtype, case_bits in cases:
        P, L = sum(sizes), len(sizes)
        g = torch.randn((C, P), generator=gen, device="cuda") * 0.01
        u = torch.rand((C, P), generator=gen, device="cuda")
        offsets = torch.tensor([0, *itertools.accumulate(sizes)], dtype=torch.int32,
                               device="cuda")
        s = torch.stack([g[:, a:b].abs().amax() for a, b in
                         zip(offsets[:-1].tolist(), offsets[1:].tolist())])
        for bits in (4, 7, 8):
            lim = 2**bits - 1
            step = s * 0.9 / lim                    # |t| reaches past lim: clipped
            got = sq.sr_pack_segments_cuda(g, offsets, step, u, lim, dtype)
            want = sq.sr_pack_segments_plain(g, offsets, step, u, lim, dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"sr_pack {label} bits={bits}: {bad} codes differ "
                                     "from the plain version")
            top = min(lim, torch.iinfo(dtype).max)
            if not bool((got.abs() == top).any()):
                raise AssertionError(f"sr_pack {label} bits={bits}: no code at the clip")
        lim = 2**case_bits - 1
        args = (g, offsets, s / lim, u, lim, dtype)
        got = sq.sr_pack_segments_cuda(*args)
        want = sq.sr_pack_segments_plain(*args)
        torch.cuda.synchronize()
        b_ms, b_by = bound_ms(count.sr_pack_segments_cost(P, C, L, dtype))
        iters = 10 if P > 1e7 else 50
        row = dict(kernel="sr_pack", case=label, clients=C, leaves=L, P=P,
                   bits=case_bits, codes=str(dtype),
                   max_abs_err=float((got.float() - want.float()).abs().max()),
                   kernel_ms=time_ms(sq.sr_pack_segments_cuda, [args], iters=iters),
                   plain_ms=time_ms(sq.sr_pack_segments_plain, [args], iters=3),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit(row)
        if label.startswith("train step"):
            table["sr_pack"] = row
        del g, u
    print("sr_pack: bit-equal to the plain version in every case (atol 0)")


#: the keyed entries' bit-equality cases: leaf sizes (none a multiple of 4,
#: so 4-groups straddle leaves) and clients
KEYED_SIZES = ([1003], [5, 130, 1], [3, 17, 2, 41, 1, 9, 66])
KEYED_CLIENTS = (1, 2, 4)


def _grads(sizes, C, gen, scale=0.01):
    """Per leaf, C clients' f32 gradients on the card."""
    return [[torch.randn(n, generator=gen, device="cuda") * scale * (i + 1)
             for _c in range(C)] for i, n in enumerate(sizes)]


def _cpu(leaves):
    return [[g.cpu() for g in leaf] for leaf in leaves]


def _same_pack(label, got, want) -> None:
    for name, a, b in zip(("codes", "step", "non-finite count"), got, want):
        if not torch.equal(a.cpu(), b.cpu()):
            bad = int((a.cpu() != b.cpu()).sum())
            raise AssertionError(f"sr_pack_keyed {label}: {bad} {name} differ from the plain "
                                 "version")


def earlier_wire(leaves, seed: int, round_idx: int, bits: int, dtype):
    """The trainer's wire as the parent tree ran it: a seeded generator and
    ``torch.rand`` for each (leaf, client), a ``torch.stack`` a leaf, the
    "raise" guard's host read a leaf, the scales, the offsets and two f32
    reciprocals built on the host, the two concatenations, K2's u-taking
    entry, the integer sum and the dequant."""
    from repro_torch.core.fwq import site_key
    from repro_torch.dist.collectives import code_bound

    dev, n = leaves[0][0].device, len(leaves[0])

    def recip(k):
        one = torch.tensor(1.0, dtype=torch.float32)
        return (one / torch.tensor(float(k), dtype=torch.float32)).to(dev)

    us = []
    for i, leaf in enumerate(leaves):
        rows = []
        for c in range(n):
            gen = torch.Generator(device=dev).manual_seed(site_key(seed, round_idx, 17, i, c))
            rows.append(torch.rand(tuple(leaf[c].shape), generator=gen, device=dev))
        us.append(torch.stack(rows))
    gfs = [torch.stack(leaf).to(torch.float32) for leaf in leaves]
    bad = sum(int((~torch.isfinite(g)).sum()) for g in gfs)
    assert bad == 0, bad
    s = torch.stack([g.abs().amax() for g in gfs])
    s = torch.where(s > 0, s, torch.ones_like(s))
    lim = code_bound(bits)
    step = s * recip(lim)
    sizes = [g[0].numel() for g in gfs]
    offsets = torch.tensor([0, *np.cumsum(sizes)], dtype=torch.int32, device=dev)
    flat = torch.cat([g.reshape(n, -1) for g in gfs], dim=1)
    uflat = torch.cat([u.reshape(n, -1) for u in us], dim=1)
    codes = sq.sr_pack_segments_cuda(flat, offsets, step, uflat, lim, dtype)
    total = codes.sum(dim=0, dtype=torch.int64).to(torch.float32)
    inv_n = recip(n)
    return [((chunk * step[i]) * inv_n).reshape(g.shape[1:])
            for i, (g, chunk) in enumerate(zip(gfs, total.split(sizes)))]


def keyed_wire(leaves, key: int, bits: int):
    """The same wire through this tree's keyed path ("raise": one host read)."""
    from repro_torch.dist.collectives import AxisCtx, quantized_psum_batch

    n = len(leaves[0])
    return quantized_psum_batch(AxisCtx(("data",), None, ("data",), (("data", n),)),
                                leaves, None, bits, key=key)


def _pass_ms(rows, frags) -> float | None:
    return sum(r[0] for r in rows if any(f in r[2] for f in frags)) if rows else None


def check_sr_pack_keyed(table: dict) -> None:
    """K2's keyed entry against its plain version with atol 0 (on the card
    and on the CPU; codes, pitch and non-finite count): bits 4, 8, 12, 16
    into int8, int16, int32 at 1, 3 and 7 ragged leaves and 1, 2, 4 clients;
    the pitch at every bits 1-31; NaN and +-Inf under "saturate" and the
    count "raise" reads; an unaligned base.  Then timed at the trainer's
    wire and at 4 x 4096 x 11008 (int8 and int16) beside the parent's chain
    at the same shape, with each pass's device time and the bound."""
    from repro_torch.core.fwq import site_key
    from repro_torch.dist import collectives as tcol

    gen = torch.Generator(device="cuda").manual_seed(6)
    key = 0x9E3779B97F4A7C15
    n_cases = 0
    for sizes in KEYED_SIZES:
        for C in KEYED_CLIENTS:
            leaves = _grads(sizes, C, gen)
            for bits in (4, 8, 12, 16):
                for dtype in sq.CODE_DTYPES:
                    lim = 2**bits - 1
                    got = sq.sr_pack_keyed_cuda(leaves, key, lim, dtype)
                    torch.cuda.synchronize()
                    label = f"L {len(sizes)} C {C} bits {bits} {dtype}"
                    _same_pack(label, got, sq.sr_pack_keyed_plain(leaves, key, lim, dtype))
                    _same_pack(label + " (CPU)", got,
                               sq.sr_pack_keyed_plain(_cpu(leaves), key, lim, dtype))
                    n_cases += 1
    leaves = _grads([37, 6], 3, gen, scale=3.0)
    for bits in range(1, 32):
        lim = 2**bits - 1
        got = sq.sr_pack_keyed_cuda(leaves, key, lim, torch.int32)
        _same_pack(f"pitch bits {bits} (CPU)", got,
                   sq.sr_pack_keyed_plain(_cpu(leaves), key, lim, torch.int32))
        n_cases += 1
    # NaN and +-Inf: "saturate" takes the codes as they are, "raise" reads the count
    leaves = _grads([9, 14, 5], 3, gen, scale=1.0)
    leaves[0][0][1], leaves[1][2][3], leaves[1][0][0] = float("nan"), float("inf"), -float("inf")
    leaves[2][1][:] = float("inf")
    got = sq.sr_pack_keyed_cuda(leaves, key, 255, torch.int16)
    _same_pack("NaN/Inf", got, sq.sr_pack_keyed_plain(_cpu(leaves), key, 255, torch.int16))
    if int(got[2]) != 8:
        raise AssertionError(f"sr_pack_keyed: non-finite count {int(got[2])}, want 8")
    axes = tcol.AxisCtx(("data",), None, ("data",), (("data", 3),))
    sat = tcol.quantized_psum_batch(axes, leaves, None, 8, key=key, on_nonfinite="saturate")
    want = tcol.quantized_psum_batch(axes, _cpu(leaves), None, 8, key=key,
                                     on_nonfinite="saturate")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(sat, want)):
        raise AssertionError("sr_pack_keyed: the saturated wire differs from the plain one")
    try:
        tcol.quantized_psum_batch(axes, leaves, None, 8, key=key)
        raise AssertionError("sr_pack_keyed: 'raise' let 8 non-finite values through")
    except FloatingPointError as e:
        if "8 non-finite gradient values" not in str(e):
            raise
    buf = torch.randn(4 * 4101 + 1, generator=gen, device="cuda")
    leaves = [[buf[1 + c * 4101:1 + (c + 1) * 4101] for c in range(4)]]   # 4-byte offsets
    got = sq.sr_pack_keyed_cuda(leaves, key, 255, torch.int16)
    _same_pack("unaligned bases", got, sq.sr_pack_keyed_plain(_cpu(leaves), key, 255,
                                                              torch.int16))
    n_cases += 3
    print(f"sr_pack_keyed: bit-equal to the plain version in all {n_cases} cases (atol 0; "
          "card and CPU; codes, pitch, count)")

    cases = [("train step wire, int16", TRAIN_WIRE_SIZES, 4, 8, torch.int16),
             ("4x4096x11008, int8", [4096 * 11008], 4, 4, torch.int8),
             ("4x4096x11008, int16", [4096 * 11008], 4, 8, torch.int16)]
    for label, sizes, C, bits, dtype in cases:
        leaves = _grads(sizes, C, gen)
        lim, P = 2**bits - 1, sum(sizes)
        args = (leaves, key, lim, dtype)
        got = sq.sr_pack_keyed_cuda(*args)
        want = sq.sr_pack_keyed_plain(*args)
        torch.cuda.synchronize()
        _same_pack(label, got, want)
        cost = count.sr_pack_keyed_cost(P, C, len(sizes), dtype)
        b_ms, b_by = bound_ms(cost)
        big = C * P > 1e7
        kernel_ms = time_ms(sq.sr_pack_keyed_cuda, [args], iters=10 if big else 50)
        passes = _device_ms_by_name(lambda: sq.sr_pack_keyed_cuda(*args), 5)
        site = (0, 2)
        earlier = _device_ms_by_name(lambda: earlier_wire(leaves, *site, bits, dtype), 3)
        entry = _device_ms_by_name(lambda: keyed_wire(leaves, site_key(*site, 17), bits), 3)
        row = dict(
            kernel="sr_pack_keyed", case=label, clients=C, leaves=len(sizes), P=P, bits=bits,
            codes=str(dtype), max_abs_err=float((got[0].float() - want[0].float()).abs().max()),
            kernel_ms=kernel_ms, bound_ms=b_ms, bound_by=b_by,
            bytes_ms=cost.bytes / H100_SXM.hbm_bw * 1e3, share_of_bound=b_ms / kernel_ms,
            absmax_pass_ms=_pass_ms(passes, ("seg_absmax",)),
            pack_pass_ms=_pass_ms(passes, ("sr_pack_keyed",)),
            wire_host_ms=time_events_ms(keyed_wire, (leaves, site_key(*site, 17), bits),
                                        iters=5 if big else 10),
            earlier_host_ms=time_events_ms(earlier_wire, (leaves, *site, bits, dtype),
                                           iters=5 if big else 10),
            wire_device_ms=sum(r[0] for r in entry) if entry else "not measured",
            earlier_device_ms=sum(r[0] for r in earlier) if earlier else "not measured",
            wire_device_ops=sum(r[1] for r in entry) if entry else "not measured",
            earlier_device_ops=sum(r[1] for r in earlier) if earlier else "not measured",
            earlier_kernels=[{"ms": ms, "count": c, "name": nm[:60]}
                             for ms, c, nm in earlier[:8]],
            plain_ms=time_events_ms(sq.sr_pack_keyed_plain, args, iters=3, warmup=1),
            library_ms=None)
        emit(row)
        if label.startswith("train step"):
            table["sr_pack_keyed"] = row
        del leaves, got, want


def earlier_fl_quantize(params, delta, seed: int, round_idx: int):
    """An fl-sim round's quantization as the parent tree ran it: a fresh
    generator seeded from (seed, round), a (C, P) ``torch.rand``, then
    ``quantize_clients`` with those uniforms (L ``tensor_scale`` reductions
    and a stack, offsets built on the host, the concatenation, K1)."""
    from repro_torch.core.fwq import site_key
    from repro_torch.core.quantization import quantizable_size, quantize_clients

    dev = delta.device
    gen = torch.Generator(device=dev).manual_seed(site_key(seed, round_idx))
    u = torch.rand((delta.shape[0], quantizable_size(params)[0]), generator=gen, device=dev)
    return quantize_clients(params, delta, u)


def keyed_fl_quantize(params, delta, key: int):
    from repro_torch.core.quantization import quantize_clients

    return quantize_clients(params, delta, key=key)


def check_sr_quant_keyed(table: dict) -> None:
    """K1's keyed segment entry against its plain version with atol 0 (on
    the card and on the CPU): 1, 3 and 7 ragged leaves at 1, 2 and 4 clients
    (bits 4, 8, 16, 32: a zero delta returns w), an all-zero leaf, a NaN
    leaf, unaligned bases; the fl rounds' leaves at 8 clients.  Then timed
    at the fl rounds' shapes and at one 4096 x 11008 leaf beside the
    parent's chain (a generator, ``torch.rand``, the scales, the host-built
    offsets, the concatenation, K1)."""
    from repro_torch.core.fwq import delta_for_clients
    from repro_torch.core.quantization import quantizable_paths

    gen = torch.Generator(device="cuda").manual_seed(7)
    key = 0xD1B54A32D192ED03
    bits_all = np.array([8, 32, 4, 16, 8, 16, 8, 16])
    n_cases = 0

    def same(label, leaves, delta):
        got = sq.sr_quant_segments_keyed_cuda(leaves, delta, key)
        torch.cuda.synchronize()
        for where, want in (
                ("plain on the card", sq.sr_quant_segments_keyed_plain(leaves, delta, key)),
                ("plain on the CPU", sq.sr_quant_segments_keyed_plain(
                    [x.cpu() for x in leaves], delta.cpu(), key).cuda())):
            # bit-equal, a NaN where the plain version has one (a NaN w stays NaN)
            nan = torch.isnan(want)
            if not (torch.equal(torch.isnan(got), nan) and
                    torch.equal(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0))):
                bad = int((got.masked_fill(nan, 0.0) != want.masked_fill(nan, 0.0)).sum())
                raise AssertionError(f"sr_quant_keyed {label}: {bad} elements differ from "
                                     f"the {where}")
        return got

    for sizes in KEYED_SIZES:
        for C in KEYED_CLIENTS:
            leaves = [x[0] * 30 for x in _grads(sizes, 1, gen)]
            delta = delta_for_clients(bits_all[:C]).cuda()
            got = same(f"L {len(sizes)} C {C}", leaves, delta)
            n_cases += 1
            if C > 1 and not torch.equal(got[1], torch.cat(leaves)):
                raise AssertionError("sr_quant_keyed: a zero delta must return w")
    delta = delta_for_clients(bits_all[:3]).cuda()
    nan_leaf = torch.randn(33, generator=gen, device="cuda")
    nan_leaf[7] = float("nan")
    buf = torch.randn(4102, generator=gen, device="cuda")
    for label, leaves in (("an all-zero leaf", [torch.zeros(41, device="cuda"),
                                                torch.randn(9, generator=gen, device="cuda")]),
                          ("a NaN leaf", [nan_leaf, torch.randn(12, generator=gen,
                                                                device="cuda")]),
                          ("unaligned bases", [buf[1:2050], buf[2051:]])):
        same(label, leaves, delta)
        n_cases += 1
    d8 = delta_for_clients(bits_all).cuda()
    for arch in ("mobilenet", "resnet"):
        params = _fl_params(arch)
        same(f"{arch} round", [params[p].reshape(-1) for _i, p in quantizable_paths(params)],
             d8)
        n_cases += 1
    print(f"sr_quant_keyed: bit-equal to the plain version in all {n_cases} cases (atol 0; "
          "card and CPU)")

    for label, arch, C in (("mobilenet round", "mobilenet", 8), ("resnet round", "resnet", 8),
                           ("4096x11008, 1 client", None, 1)):
        if arch:
            params = _fl_params(arch)
        else:
            params = {"w/w": torch.randn((4096, 11008), generator=gen, device="cuda") * 0.02}
        leaves = [params[p].reshape(-1) for _i, p in quantizable_paths(params)]
        delta = d8[:C]
        args = (leaves, delta, key)
        got = sq.sr_quant_segments_keyed_cuda(*args)
        want = sq.sr_quant_segments_keyed_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"sr_quant_keyed {label}: differs from the plain version")
        P, L = got.shape[1], len(leaves)
        b_ms, b_by = bound_ms(count.sr_quant_keyed_cost(P, C))
        big = P > 1e7
        passes = _device_ms_by_name(lambda: sq.sr_quant_segments_keyed_cuda(*args), 5)
        earlier = _device_ms_by_name(lambda: earlier_fl_quantize(params, delta, 0, 1), 3)
        entry = _device_ms_by_name(lambda: keyed_fl_quantize(params, delta, key), 3)
        kernel_ms = time_ms(sq.sr_quant_segments_keyed_cuda, [args], iters=10 if big else 50)
        row = dict(
            kernel="sr_quant_keyed", case=label, clients=C, leaves=L, P=P,
            max_abs_err=float((got - want).abs().max()), kernel_ms=kernel_ms,
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / kernel_ms,
            absmax_pass_ms=_pass_ms(passes, ("seg_absmax",)),
            rounding_pass_ms=_pass_ms(passes, ("sr_quant_keyed",)),
            entry_host_ms=time_events_ms(keyed_fl_quantize, (params, delta, key),
                                         iters=3 if big else 10),
            earlier_host_ms=time_events_ms(earlier_fl_quantize, (params, delta, 0, 1),
                                           iters=3 if big else 10),
            entry_device_ms=sum(r[0] for r in entry) if entry else "not measured",
            earlier_device_ms=sum(r[0] for r in earlier) if earlier else "not measured",
            entry_device_ops=sum(r[1] for r in entry) if entry else "not measured",
            earlier_device_ops=sum(r[1] for r in earlier) if earlier else "not measured",
            earlier_kernels=[{"ms": ms, "count": c, "name": nm[:60]}
                             for ms, c, nm in earlier[:8]],
            plain_ms=time_events_ms(sq.sr_quant_segments_keyed_plain, args, iters=3, warmup=1),
            library_ms=None)
        emit(row)
        if label == "mobilenet round":
            table["sr_quant_keyed"] = row
        del params, leaves, got, want


def _split_sizes(L: int) -> list:
    """Leaf sizes of the tree-splitting checks: ragged, so that 4-groups
    straddle leaves and the tables' seams."""
    return [4 * (1 + (7 * i) % 23) + 1 + i % 3 for i in range(L)]


def check_keyed_splits() -> None:
    """The keyed entries on trees past one table, through ``ops`` (the path
    the fl round and the trainer's wire take): K1 at 65 leaves (tables of
    64 and 1), K2 at 26 clients x 10 leaves (9 + 1) and 4 x 70 (64 + 6).
    Each is bit-equal to the ops call on CPU copies (the plain versions in
    the same groups), to the u-taking entry on the card fed
    ``ref.philox_streams_plain`` of the same key over the whole tree, and,
    on the first table's leaves, to the one-table call with the same key;
    K2's non-finite count is summed over the groups."""
    from repro_torch.core.fwq import delta_for_clients
    from repro_torch.kernels.ref import f32_reciprocal, philox_streams_plain

    gen = torch.Generator(device="cuda").manual_seed(21)
    key = 0xA0761D6478BD642F
    sizes = _split_sizes(65)
    leaves = [torch.randn(n, generator=gen, device="cuda") * (1 + i % 5)
              for i, n in enumerate(sizes)]
    delta = delta_for_clients(np.array([8, 4, 16])).cuda()
    n0 = ops.LAUNCHES["sr_quant_keyed"]
    got = ops.sr_quantize_segments_keyed(leaves, delta, key)
    torch.cuda.synchronize()
    groups = ops.LAUNCHES["sr_quant_keyed"] - n0
    assert groups == 2, groups
    w = torch.cat(leaves)
    offsets = torch.tensor([0, *itertools.accumulate(sizes)], dtype=torch.int32, device="cuda")
    s = torch.stack([x.abs().amax() for x in leaves])
    u = philox_streams_plain(key, 3, w.numel(), "cuda")
    one = sq.sr_quant_segments_keyed_cuda(leaves[:64], delta, key)
    for label, want in (
            ("the plain split on the CPU", ops.sr_quantize_segments_keyed(
                [x.cpu() for x in leaves], delta.cpu(), key)),
            ("the u-taking entry fed the key's streams", sq.sr_quant_segments_cuda(
                w, offsets, torch.where(s > 0, s, torch.ones_like(s)), delta, u)),
            ("the one-table call", one)):
        if not torch.equal(got[:, :want.shape[1]].cpu(), want.cpu()):
            raise AssertionError(f"keyed K1 at 65 leaves: differs from {label}")
    print(f"keyed K1 split: 65 leaves in {groups} tables, bit-equal to the plain split, to "
          "the u-taking entry fed the key's streams and to the one-table call")
    for C, L in ((26, 10), (4, 70)):
        sizes = _split_sizes(L)
        leaves = _grads(sizes, C, gen)
        leaves[-1][C - 1][2] = float("nan")             # counted in the last table
        n0 = ops.LAUNCHES["sr_pack_keyed"]
        got = ops.sr_pack_keyed(leaves, key, 127, torch.int16)
        torch.cuda.synchronize()
        groups = ops.LAUNCHES["sr_pack_keyed"] - n0
        assert groups == 2, groups
        _same_pack(f"{C} x {L} split (CPU)", got,
                   ops.sr_pack_keyed(_cpu(leaves), key, 127, torch.int16))
        if int(got[2]) != 1:
            raise AssertionError(f"keyed K2 {C} x {L}: count {int(got[2])}, want 1")
        rows = [torch.nan_to_num(torch.stack(leaf), nan=0.0) for leaf in leaves]
        step = torch.stack([r.abs().amax() for r in rows]) * f32_reciprocal(127)
        g = torch.cat(rows, dim=1)
        offsets = torch.tensor([0, *itertools.accumulate(sizes)], dtype=torch.int32,
                               device="cuda")
        want = sq.sr_pack_segments_cuda(g, offsets, step, philox_streams_plain(
            key, C, g.shape[1], "cuda"), 127, torch.int16)
        if not (torch.equal(got[0], want) and torch.equal(got[1], step)):
            raise AssertionError(f"keyed K2 {C} x {L}: differs from the u-taking entry fed "
                                 "the key's streams")
        l1 = sq.table_groups(sizes, C, "check")[0][1]
        one = sq.sr_pack_keyed_cuda(leaves[:l1], key, 127, torch.int16)
        if not (torch.equal(got[0][:, :one[0].shape[1]], one[0]) and
                torch.equal(got[1][:l1], one[1])):
            raise AssertionError(f"keyed K2 {C} x {L}: differs from the one-table call")
        print(f"keyed K2 split: {C} clients x {L} leaves in {groups} tables, bit-equal to "
              "the plain split, to the u-taking entry fed the key's streams and to the "
              "one-table call; the NaN counted once")


#: K3 at the MoE experts' shapes: (model, projection, K, N).
EXPERT_SHAPES = (("olmoe-1b-7b", "up/gate", 2048, 1024), ("olmoe-1b-7b", "down", 1024, 2048),
                 ("qwen3-moe-235b-a22b", "up/gate", 4096, 1536),
                 ("qwen3-moe-235b-a22b", "down", 1536, 4096))
#: M: a 4-slot decode step's capacity, and a 4 x 128 prefill's
#: (int(512 * 8 * 1.25 / 64) + 1; qwen3's 128 experts give 41)
EXPERT_MS = {"olmoe-1b-7b": (4, 81), "qwen3-moe-235b-a22b": (4, 41)}


def check_quant_matmul_experts() -> None:
    """K3 at each expert shape and capacity, bf16 (the serving path) and f32
    (phase consistency's qwen3) x with int8 codes: within the K3 rows'
    tolerance of the plain version, bit-equal over two launches, and planned
    onto the cluster path (M 4) or, for bf16, the wgmma path (never the FP32
    tiled one: every expert's code rows are 16-byte multiples).  Each timed
    beside ``torch.matmul`` on the dequantized weight and the bound; a
    layer's experts are as many distinct weights, so the timed launches
    rotate over copies enough to read each from device memory."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for arch, proj, K, N in EXPERT_SHAPES:
        codes = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
        scale = torch.tensor(2.0 / math.sqrt(K) / 127, device="cuda")
        n_copies = max(1, min(16, math.ceil(120e6 / codes.nbytes)))
        copies = [codes] + [codes.clone() for _ in range(n_copies - 1)]
        for x_dtype in (torch.bfloat16, torch.float32):
            w_libs = [(c.float() * scale).to(x_dtype) for c in copies]
            for M in EXPERT_MS[arch]:
                x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
                got = qm.quant_matmul_cuda(x, codes, scale)
                again = qm.quant_matmul_cuda(x, codes, scale)
                want = qm.quant_matmul_plain(x, codes, scale)
                torch.cuda.synchronize()
                case = f"quant_matmul {arch} {proj} M={M} K={K} N={N} x={x_dtype}"
                rtol, atol = (1e-4, 1e-3) if x_dtype == torch.float32 else (2e-2, 1e-2)
                _check(case, got, want, rtol, atol)
                if not torch.equal(got, again):
                    raise AssertionError(f"{case}: two launches on identical inputs differ")
                p = qm.plan(M, K, N, x_dtype, torch.int8)
                want_path = "cluster" if M <= 16 else (
                    "wgmma" if x_dtype == torch.bfloat16 else "tiled")
                assert p.path == want_path, (case, p)
                sets = [(x, c, scale) for c in copies]
                b_ms, b_by = bound_ms(count.quant_matmul_cost(M, K, N, x_dtype, torch.int8))
                emit(dict(kernel="quant_matmul", case=f"{arch} expert {proj}", M=M, K=K, N=N,
                          x=str(x_dtype), codes="torch.int8", plan=list(p),
                          max_abs_err=max_errs(got, want)[0],
                          kernel_ms=time_ms(qm.quant_matmul_cuda, sets),
                          plain_ms=time_ms(qm.quant_matmul_plain, sets[:1], iters=3, warmup=1),
                          library_ms=time_ms(torch.matmul, [(x, w) for w in w_libs]),
                          bound_ms=b_ms, bound_by=b_by))
            del w_libs
        del copies, codes


def k3_path(M: int, N: int, x_dtype) -> str:
    """The path ``quant_matmul.plan`` gives int8 codes of 16-byte-aligned
    operands: TMA needs code rows of a 16-byte multiple, so other widths
    (mamba2's 50,280 and seamless-m4t's 256,206 vocabularies, a tp shard's
    12-byte ``w_dt`` rows) take the ragged path at M up to 16 and the FP32
    tiled path above; M up to 16 the cluster path; a larger M the wgmma path
    in bf16 and the tiled one in f32."""
    if M <= 16:
        return "ragged" if N % 16 else "cluster"
    return "wgmma" if x_dtype == torch.bfloat16 and N % 16 == 0 else "tiled"


#: the plan every M <= 16 launch that TMA cannot address took before the
#: ragged path: its time beside the new path's ("earlier" in PERF.md)
K3_TILED = qm.Plan("tiled", 128, 128, 1)


def earlier_k3_ms(p, sets) -> float | None:
    """The old tiled plan's device time on the same inputs, where ``p`` is
    the ragged path (else None)."""
    if p.path != "ragged":
        return None
    return time_ms(lambda x, c, s: qm.quant_matmul_cuda(x, c, s, tile_plan=K3_TILED), sets)


#: K3 at each projection shape of the families that serve without experts:
#: (model, projection, M, K, N, x dtypes, launches).  M 4 is a 4-slot decode
#: step; mamba2 (d 1536, d_inner 3072, 48 heads, state 128, vocab 50,280)
#: prefills by decode steps; seamless-m4t (d 1024, d_ff 8192, vocab
#: 256,206) runs its encoder at M 4 x 256 frames; llama-3.2-vision (d 8192,
#: 8 KV heads of 128, d_ff 28,672, vocab 128,256) projects its 4 x 1,601
#: image tokens (width 1,280) at prefill; yi-6b as one data shard of phase
#: serve_dist's 4x1 mesh runs it: one slot (M 1) in a decode step and in
#: the unembed of a prefill, one slot's 64- or 128-token bucket in the
#: prefill's layers.  f32 x where phase consistency runs the model in f32.
#: Launches: a decode step's (a prefill's for the prefill rows) at the
#: served depth (llama-3.2-vision: 2 periods), a shard's for yi-6b.
_BOTH = (torch.bfloat16, torch.float32)
_BF16 = (torch.bfloat16,)
K3_MODEL_SHAPES = (
    ("mamba2-780m", "wx", 4, 1536, 3072, _BOTH, 48), ("mamba2-780m", "wz", 4, 1536, 3072, _BOTH, 48),
    ("mamba2-780m", "w_bc", 4, 1536, 256, _BOTH, 48), ("mamba2-780m", "w_dt", 4, 1536, 48, _BOTH, 48),
    ("mamba2-780m", "wo", 4, 3072, 1536, _BOTH, 48),
    ("mamba2-780m", "unembed", 4, 1536, 50280, _BOTH, 1),
    ("seamless-m4t-large-v2", "q/k/v/o, cross q/o", 4, 1024, 1024, _BOTH, 144),
    ("seamless-m4t-large-v2", "up/gate", 4, 1024, 8192, _BOTH, 48),
    ("seamless-m4t-large-v2", "down", 4, 8192, 1024, _BOTH, 24),
    ("seamless-m4t-large-v2", "unembed", 4, 1024, 256206, _BOTH, 1),
    ("seamless-m4t-large-v2", "encoder q/k/v/o, adapter, cross k/v", 1024, 1024, 1024, _BOTH,
     145),
    ("seamless-m4t-large-v2", "encoder up/gate", 1024, 1024, 8192, _BOTH, 48),
    ("seamless-m4t-large-v2", "encoder down", 1024, 8192, 1024, _BOTH, 24),
    ("llama-3.2-vision-90b", "wq/wo", 4, 8192, 8192, _BF16, 20),
    ("llama-3.2-vision-90b", "wk/wv", 4, 8192, 1024, _BF16, 16),
    ("llama-3.2-vision-90b", "up/gate", 4, 8192, 28672, _BF16, 20),
    ("llama-3.2-vision-90b", "down", 4, 28672, 8192, _BF16, 10),
    ("llama-3.2-vision-90b", "unembed", 4, 8192, 128256, _BF16, 1),
    ("llama-3.2-vision-90b", "adapter", 4 * 1601, 1280, 8192, _BF16, 1),
    ("llama-3.2-vision-90b", "cross wk/wv", 4 * 1601, 8192, 1024, _BF16, 4),
    ("yi-6b", "unembed, one shard", 1, 4096, 64000, _BF16, 1))
K3_MODEL_SHAPES += tuple(
    ("yi-6b", f"{proj}, one shard's {kind}", M, K, N, _BF16, n)
    for kind, Ms in (("decode", (1,)), ("prefill", (64, 128))) for M in Ms
    for proj, K, N, n in (("wq/wo", 4096, 4096, 64), ("wk/wv", 4096, 512, 64),
                          ("up/gate", 4096, 11008, 64), ("down", 11008, 4096, 32)))
#: glm4-9b's depth in phase serve_tp's serve: 8 of its 40 layers, cut for the
#: script's time limit (each layer's 81 bf16 all-reduces of a 4-slot,
#: 128-token prefill go through the host over gloo)
SERVE_TP_GLM_LAYERS = 8
#: yi-6b's depth in phase serve_tp's serve: 8 of its 32 layers (32 until
#: phase train_tp joined the tp ranks: ~25 s of the script's time limit)
SERVE_TP_YI_LAYERS = 8
#: One model shard of phase serve_tp's 1x4 mesh, yi-6b and glm4-9b at full
#: width: the column-parallel wq, up and gate and the vocab at a quarter of
#: their outputs, the row-parallel wo and down at a quarter of their inputs;
#: yi-6b's 4 KV heads split (one a shard), glm4-9b's 2 replicated (wk/wv
#: whole).  In bf16 as the serves run them: a 4-slot decode step (M 4) and a
#: prefill of 4 slots in the 128-token bucket (M 512; the unembed reads the
#: last positions, M 4), launches a decode step's or a prefill's on one rank
#: at the served depth (yi-6b ``SERVE_TP_YI_LAYERS``, glm4-9b
#: ``SERVE_TP_GLM_LAYERS``).
#: In f32 as the step-level runs take them (``SERVE_TP_STEPS``: 4 layers,
#: prompts padded to 200 tokens): M 4 a decode step, M 800 the prefill,
#: launches a pass's on one rank.
_TP_SHARD_PROJ = {
    "yi-6b": (("wq", 4096, 1024, 1), ("wk/wv", 4096, 128, 2), ("wo", 1024, 4096, 1),
              ("up/gate", 4096, 2752, 2), ("down", 2752, 4096, 1)),
    "glm4-9b": (("wq", 4096, 1024, 1), ("wk/wv", 4096, 256, 2), ("wo", 1024, 4096, 1),
                ("up/gate", 4096, 3424, 2), ("down", 3424, 4096, 1))}
_TP_VOCAB_LOCAL = {"yi-6b": 16000, "glm4-9b": 37888}
_TP_SERVED_LAYERS = {"yi-6b": SERVE_TP_YI_LAYERS, "glm4-9b": SERVE_TP_GLM_LAYERS}
K3_MODEL_SHAPES += tuple(
    (arch, f"{proj}, one of 4 model shards' {kind}", M, K, N, _BF16, a_layer * L)
    for arch, rows in _TP_SHARD_PROJ.items() for L in (_TP_SERVED_LAYERS[arch],)
    for kind, M in (("decode", 4), ("prefill", 512)) for proj, K, N, a_layer in rows)
K3_MODEL_SHAPES += tuple(
    (arch, f"{proj}, one of 4 model shards' step-level {kind}", M, K, N, (torch.float32,),
     a_layer * 4)
    for arch, rows in _TP_SHARD_PROJ.items()
    for kind, M in (("decode", 4), ("prefill", 800)) for proj, K, N, a_layer in rows)
K3_MODEL_SHAPES += tuple(
    (arch, f"unembed, one of 4 model shards{step}", 4, 4096, _TP_VOCAB_LOCAL[arch], dtypes, 1)
    for arch in _TP_SHARD_PROJ
    for step, dtypes in (("", _BF16), (" step-level", (torch.float32,))))
#: One model shard of phase serve_tp_families' 1x4 mesh: (arch, projection,
#: M, K, N, x dtypes, launches a pass of the serve on a rank (the depth
#: ``SERVE_TP_FAMILY_RUNS`` serves)).  bf16 as the serves run them, f32 as
#: the step-level runs (``SERVE_TP_FAMILY_STEPS``); M 4 a decode step (and a
#: prefill by decode's every token); the column-parallel outputs, the
#: row-parallel inputs and the vocab (padded to a shard's ``padded_vocab_local``)
#: at a quarter, the replicated ones whole.  mamba2 (d 1536, d_inner 3,072
#: -> 768, 48 heads -> 12, the B/C projection 2 x 128 whole, vocab 50,280 ->
#: 12,570): ``w_dt``'s 12 code bytes a row and the unembed's 12,570 take K3's
#: ragged path.  seamless-m4t (16 heads of 64 -> 4, d_ff 8,192 -> 2,048,
#: vocab 256,206 -> 64,052, ragged): a decode step, and the encoder over 4 x
#: 256 frames (M 1,024; the adapter whole; each decoder layer's cross K/V).
#: llama-3.2-vision (64 heads of 128 -> 16, 8 KV heads -> 2, d_ff 28,672 ->
#: 7,168, vocab 128,256 -> 32,064): a decode step, a prefill of 4 slots in
#: the 64-token bucket (M 256; the unembed at the last positions, M 4), the
#: image memory's 4 x 1,601 tokens through the whole adapter and each cross
#: layer's K/V (M 6,404).  jamba at its smoke size, f32 (d 64, 4 heads of 16
#: -> 1, 4 experts -> 1, d_ff 128 -> 32, d_inner 128 -> 32, 8 SSM heads ->
#: 2, vocab 512 -> 128), every pass at M 4.
K3_MODEL_SHAPES += (
    ("mamba2-780m", "wx/wz, one of 4 model shards", 4, 1536, 768, _BOTH, 16),
    ("mamba2-780m", "w_bc (whole), one of 4 model shards", 4, 1536, 256, _BOTH, 8),
    ("mamba2-780m", "w_dt, one of 4 model shards", 4, 1536, 12, _BOTH, 8),
    ("mamba2-780m", "wo, one of 4 model shards", 4, 768, 1536, _BOTH, 8),
    ("mamba2-780m", "unembed, one of 4 model shards", 4, 1536, 12570, _BOTH, 1),
    ("seamless-m4t-large-v2", "q/k/v, cross q, one of 4 model shards", 4, 1024, 256, _BOTH, 16),
    ("seamless-m4t-large-v2", "o, cross o, one of 4 model shards", 4, 256, 1024, _BOTH, 8),
    ("seamless-m4t-large-v2", "up/gate, one of 4 model shards", 4, 1024, 2048, _BOTH, 8),
    ("seamless-m4t-large-v2", "down, one of 4 model shards", 4, 2048, 1024, _BOTH, 4),
    ("seamless-m4t-large-v2", "unembed, one of 4 model shards", 4, 1024, 64052, _BOTH, 1),
    ("seamless-m4t-large-v2", "encoder q/k/v, cross k/v, one of 4 model shards", 1024, 1024,
     256, _BOTH, 20),
    ("seamless-m4t-large-v2", "encoder o, one of 4 model shards", 1024, 256, 1024, _BOTH, 4),
    ("seamless-m4t-large-v2", "encoder up/gate, one of 4 model shards", 1024, 1024, 2048, _BOTH,
     8),
    ("seamless-m4t-large-v2", "encoder down, one of 4 model shards", 1024, 2048, 1024, _BOTH,
     4),
    ("seamless-m4t-large-v2", "adapter (whole), one of 4 model shards", 1024, 1024, 1024,
     _BOTH, 1))
K3_MODEL_SHAPES += tuple(
    ("llama-3.2-vision-90b", f"{proj}, one of 4 model shards' {kind}", M, K, N, _BOTH, n)
    for kind, M in (("decode", 4), ("prefill", 256))
    for proj, K, N, n in (("wq, cross wq", 8192, 2048, 10), ("wk/wv", 8192, 256, 16),
                          ("wo, cross wo", 2048, 8192, 10), ("up/gate", 8192, 7168, 20),
                          ("down", 7168, 8192, 10))) + (
    ("llama-3.2-vision-90b", "unembed, one of 4 model shards", 4, 8192, 32064, _BOTH, 1),
    ("llama-3.2-vision-90b", "adapter (whole), one of 4 model shards", 4 * 1601, 1280, 8192,
     _BOTH, 1),
    ("llama-3.2-vision-90b", "cross wk/wv, one of 4 model shards", 4 * 1601, 8192, 256, _BOTH,
     4))
K3_MODEL_SHAPES += tuple(
    ("jamba-1.5-large-398b smoke", f"{proj}, one of 4 model shards", 4, K, N,
     (torch.float32,), n)
    for proj, K, N, n in (("attention wq/wk/wv", 64, 16, 6), ("attention wo", 16, 64, 2),
                          ("SSM wx/wz, w_bc (whole), expert up/gate, mlp up/gate", 64, 32, 14),
                          ("SSM w_dt", 64, 2, 2), ("SSM wo, expert down, mlp down", 32, 64, 6),
                          ("unembed", 64, 128, 1)))


def check_quant_matmul_models() -> None:
    """K3 at each of :data:`K3_MODEL_SHAPES` with int8 codes: within the K3
    rows' tolerance of the plain version, bit-equal over two launches, the
    plan printed and asserted (:func:`k3_path`).  Each timed beside
    ``torch.matmul`` on the dequantized weight and the bound; the timed
    launches rotate over enough copies of the codes to read them from device
    memory, as a decode step does."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for arch, proj, M, K, N, x_dtypes, n_launches in K3_MODEL_SHAPES:
        codes = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
        scale = torch.tensor(2.0 / math.sqrt(K) / 127, device="cuda")
        n_copies = max(1, min(16, math.ceil(120e6 / codes.nbytes)))
        copies = [codes] + [codes.clone() for _ in range(n_copies - 1)]
        for x_dtype in x_dtypes:
            w_libs = [(c.float() * scale).to(x_dtype) for c in copies]
            x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
            got = qm.quant_matmul_cuda(x, codes, scale)
            again = qm.quant_matmul_cuda(x, codes, scale)
            want = qm.quant_matmul_plain(x, codes, scale)
            torch.cuda.synchronize()
            case = f"quant_matmul {arch} {proj} M={M} K={K} N={N} x={x_dtype}"
            rtol, atol = (1e-4, 1e-3) if x_dtype == torch.float32 else (2e-2, 1e-2)
            _check(case, got, want, rtol, atol)
            if not torch.equal(got, again):
                raise AssertionError(f"{case}: two launches on identical inputs differ")
            p = qm.plan(M, K, N, x_dtype, torch.int8)
            assert p.path == k3_path(M, N, x_dtype), (case, p)
            print(f"{case}: plan {tuple(p)}")
            sets = [(x, c, scale) for c in copies]
            b_ms, b_by = bound_ms(count.quant_matmul_cost(M, K, N, x_dtype, torch.int8))
            emit(dict(kernel="quant_matmul", case=f"{arch} {proj}", M=M, K=K, N=N,
                      x=str(x_dtype), codes="torch.int8", plan=list(p),
                      max_abs_err=max_errs(got, want)[0],
                      kernel_ms=time_ms(qm.quant_matmul_cuda, sets),
                      earlier_ms=earlier_k3_ms(p, sets),
                      plain_ms=time_ms(qm.quant_matmul_plain, sets[:1], iters=3, warmup=1),
                      library_ms=time_ms(torch.matmul, [(x, w) for w in w_libs]),
                      bound_ms=b_ms, bound_by=b_by, launches_on_the_path=n_launches))
            del w_libs, x, got, again, want
        del copies, codes
        torch.cuda.empty_cache()


def phase_kernels(table: dict) -> None:
    check_sr_quant(table)
    check_sr_quant_keyed(table)
    check_sr_quant_inline(table)
    check_sr_pack(table)
    check_sr_pack_keyed(table)
    check_keyed_splits()
    check_sr_tp_shapes()
    check_quant_matmul(table)
    check_quant_matmul_ragged()
    check_quant_matmul_experts()
    check_quant_matmul_models()
    check_flash_attention(table)
    check_attention_one_hot()
    check_flash_decode(table)
    print("kernels: all five agree with their plain versions (K1 through its three entries, "
          "K2 through both)")


#: The serve runs: yi-6b as in every earlier slice, then gemma-7b (head dim
#: 256 through K4 and K5), olmoe-1b-7b (64 experts top-8: every expert's FFN
#: through K3) and mamba2-780m (SSM: K3 only, the state contiguous), all at
#: full width and depth, 4 slots, s_max 256; then jamba at its smoke size
#: (the hybrid: K3, and K5 in the decode steps; its prefill is a loop of
#: decode steps on the gather path, so no K4); then the cross-attention
#: families: seamless-m4t at full width and depth (24 + 24 layers: the
#: encoder's K4 non-causal, the decoder from BOS over the cross K/V of 256
#: frames a slot) and llama-3.2-vision at full width cut to 2 periods
#: (``cut``: 10 of its 100 layers, the rest do not fit one card).
#: ``kernels``: the serving kernels the run must launch; the others of K3,
#: K4, K5 it must not.
_ATTN_KERNELS = ("quant_matmul", "flash_attention", "flash_decode")
SERVE_RUNS = {
    "yi-6b": dict(layers=32, d_model=4096, kernels=_ATTN_KERNELS, options={
        "prompt_len": 128, "requests": 8, "max_new": 32, "steps": 64}),
    "gemma-7b": dict(layers=28, d_model=3072, kernels=_ATTN_KERNELS, options={
        "prompt_len": 64, "requests": 4, "max_new": 8, "steps": 32}),
    "olmoe-1b-7b": dict(layers=16, d_model=2048, kernels=_ATTN_KERNELS, options={
        "prompt_len": 64, "requests": 4, "max_new": 16, "steps": 32}),
    "mamba2-780m": dict(layers=48, d_model=1536, kernels=("quant_matmul",), options={
        "prompt_len": 64, "requests": 4, "max_new": 16, "steps": 32}),
    "jamba-1.5-large-398b": dict(layers=4, d_model=64, smoke=True,
                                 kernels=("quant_matmul", "flash_decode"), options={
                                     "prompt_len": 16, "requests": 4, "max_new": 8,
                                     "steps": 24}),
    "seamless-m4t-large-v2": dict(layers=24, d_model=1024, kernels=_ATTN_KERNELS, options={
        "prompt_len": 64, "requests": 4, "max_new": 16, "steps": 32}),
    "llama-3.2-vision-90b": dict(layers=10, d_model=8192, cut=dict(n_layers=10),
                                 kernels=_ATTN_KERNELS, options={
                                     "prompt_len": 64, "requests": 4, "max_new": 8,
                                     "steps": 24}),
}


def k3_per_pass(cfg, tp: int = 1) -> int:
    """K3 launches a decode step or a (parallel) prefill on one of ``tp``
    model shards: q, k, v, o and the MLP's three projections a layer
    (dense), or q, k, v, o and three a layer for each of the shard's
    experts (MoE), wx, wz, w_bc, w_dt, wo a layer (SSM), a hybrid's
    sublayers by kind (attention 4, SSM 5, MoE 3 an expert of the shard,
    MLP 3); and the head."""
    e_local = cfg.n_experts // tp
    if cfg.family == "ssm":
        return 5 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        p = cfg.attn_period
        n_moe = sum(1 for j in range(p) if j % max(cfg.moe_period, 1) == 0) \
            if cfg.n_experts else 0
        per_period = 4 + 5 * (p - 1) + 3 * e_local * n_moe + 3 * (p - n_moe)
        return per_period * (cfg.n_layers // p) + 1
    per_layer = 4 + 3 * e_local if cfg.family == "moe" else 7
    return per_layer * cfg.n_layers + 1


def expected_launches(cfg, kind: str, prompt_len: int, tp: int = 1) -> dict:
    """K3, K4 and K5 launches of one ``kind`` ("decode" step or "prefill" of
    ``prompt_len`` tokens): the SSM and hybrid families prefill as a loop of
    decode steps, their attention (hybrid) on the gather path.  A VLM
    prefill projects the image memory (the adapter) and each cross layer's
    K/V, which its decode steps read cached: a cross layer is 7 K3 launches
    in prefill and 5 in decode, a self layer 7 and K4 or K5 once.  An
    enc-dec prefill runs the encoder (the adapter, 7 K3 a layer, K4
    non-causal) and each decoder layer's cross K/V, no unembed; a decode
    step 9 K3 a decoder layer (self 4, cross q and o, MLP 3), K5 once.  On
    one of ``tp`` model shards the counts are the same (every projection is
    one launch at the shard's width), a MoE layer's but for the shard's
    experts."""
    prefill = kind == "prefill"
    if cfg.family == "vlm":
        n_periods, per = cfg.n_layers // cfg.cross_attn_period, cfg.cross_attn_period
        n_self = n_periods * (per - 1)
        return {"quant_matmul": (7 * cfg.n_layers + 2 if prefill
                                 else (5 + 7 * (per - 1)) * n_periods + 1),
                "flash_attention": n_self if prefill else 0,
                "flash_decode": 0 if prefill else n_self}
    if cfg.family == "encdec":
        return {"quant_matmul": (1 + 7 * cfg.n_encoder_layers + 2 * cfg.n_layers if prefill
                                 else 9 * cfg.n_layers + 1),
                "flash_attention": cfg.n_encoder_layers if prefill else 0,
                "flash_decode": 0 if prefill else cfg.n_layers}
    recurrent = cfg.family in ("ssm", "hybrid")
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_period, 1)}.get(
        cfg.family, cfg.n_layers)
    prefill = kind == "prefill"
    return {"quant_matmul": k3_per_pass(cfg, tp) * (prompt_len if prefill and recurrent else 1),
            "flash_attention": n_attn if prefill and not recurrent else 0,
            "flash_decode": 0 if prefill else n_attn}


@contextlib.contextmanager
def k3_and_experts(record: dict):
    """Counts K3's launches by shape (``"MxKxN dtype"``), K4's by mask
    (``causal`` / ``non_causal``) and by shape (``"BHxSxD dtype"``), K5's by
    shape (``"BxKVxGxhdxpagexn_pmax q_dtype pool_dtype"``) and each
    ``expert_dispatch`` call by branch: ``k3`` (a packed stack with one
    scale), ``eager`` (a per-expert scale row, dequantized) or ``plain``."""
    shapes, branches = record.setdefault("k3_shapes", {}), record.setdefault("experts", {})
    plans, masks = record.setdefault("k3_plans", {}), record.setdefault("k4_masks", {})
    k4_shapes, k5_shapes = record.setdefault("k4_shapes", {}), record.setdefault("k5_shapes", {})
    launch, dispatch, attend = qm.quant_matmul_cuda, ops.expert_dispatch, fa.flash_attention_cuda
    decode = fa.flash_decode_cuda

    def counting_launch(x, codes, scale, tile_plan=None):
        k = f"{x.shape[0]}x{x.shape[1]}x{codes.shape[1]} {str(x.dtype)[6:]}"
        shapes[k] = shapes.get(k, 0) + 1
        if k not in plans:
            plans[k] = list(qm.plan(x.shape[0], x.shape[1], codes.shape[1], x.dtype,
                                    codes.dtype, aligned=x.data_ptr() % 16 == 0
                                    and codes.data_ptr() % 16 == 0))
        return launch(x, codes, scale, tile_plan)

    def counting_dispatch(x, w, dtype=None):
        packed = hasattr(w, "codes")
        b = ("k3" if w.scale.ndim == 0 else "eager") if packed else "plain"
        branches[b] = branches.get(b, 0) + 1
        return dispatch(x, w, dtype)

    def counting_attend(q, k, v, causal=True, attn_plan=None):
        m = "causal" if causal else "non_causal"
        masks[m] = masks.get(m, 0) + 1
        shape = f"{'x'.join(map(str, q.shape))} {str(q.dtype)[6:]}"
        k4_shapes[shape] = k4_shapes.get(shape, 0) + 1
        return attend(q, k, v, causal, attn_plan)

    def counting_decode(q, kp, vp, pt, lengths, decode_plan=None):
        shape = (f"{'x'.join(map(str, (*q.shape, kp.shape[1], pt.shape[1])))} "
                 f"{str(q.dtype)[6:]} {str(kp.dtype)[6:]}")
        k5_shapes[shape] = k5_shapes.get(shape, 0) + 1
        return decode(q, kp, vp, pt, lengths, decode_plan)

    qm.quant_matmul_cuda, ops.expert_dispatch = counting_launch, counting_dispatch
    fa.flash_attention_cuda, fa.flash_decode_cuda = counting_attend, counting_decode
    try:
        yield record
    finally:
        qm.quant_matmul_cuda, ops.expert_dispatch = launch, dispatch
        fa.flash_attention_cuda, fa.flash_decode_cuda = attend, decode


def phase_serve(dev: dict) -> dict:
    """Each serve run with the launch counters zeroed just before and read
    just after; returns the runs' launches summed."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.models.model import count_passes

    import dataclasses

    total = {name: 0 for name in KERNELS}
    for arch, run in SERVE_RUNS.items():
        smoke = run.get("smoke", False)
        spec = RunSpec(arch, workload="serve", smoke=smoke, seed=0, batch=4, seq=256,
                       precision=PrecisionPolicy.lazy_int8(7),
                       options={"attn_impl": "flash", "kv_layout": "paged",
                                "vary_prompt": True, "quiet": True, **run["options"]})
        sess = Session(spec, device="cuda")
        if "cut" in run:
            sess.cfg = dataclasses.replace(sess.cfg, **run["cut"])
        # the serve's prefills and decode steps, counted where the session
        # calls the model
        passes = {"prefill": 0, "decode": 0}
        sess.model = count_passes(sess.model, passes)
        torch.cuda.reset_peak_memory_stats()
        record: dict = {}
        ops.reset_launches()
        t0 = time.time()
        with k3_and_experts(record):
            stats = sess.serve()
        wall = time.time() - t0
        launches = dict(ops.LAUNCHES)
        cfg = sess.cfg
        vocab = cfg.vocab_size
        assert (cfg.n_layers, cfg.d_model) == (run["layers"], run["d_model"]), cfg
        n_req = run["options"]["requests"]
        assert stats.admitted == n_req, stats.admitted
        assert stats.completed == n_req, stats.completed
        pre, dec = (expected_launches(cfg, kind, 0) for kind in ("prefill", "decode"))
        if cfg.family in ("ssm", "hybrid"):
            # every decode step and every step of a prefill by decode
            # launches the family's K3 count
            per_pass = k3_per_pass(cfg)
            assert launches["quant_matmul"] % per_pass == 0, (per_pass, launches)
        else:
            # exactly the family's counts a prefill and a decode step
            want = {k: passes["prefill"] * pre[k] + passes["decode"] * dec[k] for k in pre}
            assert {k: launches[k] for k in want} == want, (passes, launches, want)
            assert record["k4_masks"] == {("non_causal" if cfg.family == "encdec" else
                                           "causal"): launches["flash_attention"]}, record
        if cfg.family == "moe":
            # every expert FFN took K3 (one launch an expert), never the
            # eager dequant: three dispatches a layer a pass
            n_passes = passes["prefill"] + passes["decode"]
            assert record["experts"] == {"k3": 3 * cfg.n_layers * n_passes}, record["experts"]
        if cfg.family == "ssm":
            # O(1) state: the paged layout asked for falls back to contiguous
            assert per_pass == 241 and stats.kv_layout == "contiguous", (per_pass, stats)
        # every K3 shape on its path (k3_path), the decode step's unembed
        # among them: ragged at mamba2's and seamless-m4t's vocabularies,
        # cluster at llama-3.2-vision's
        unembed = f"4x{cfg.d_model}x{cfg.vocab_size} {cfg.compute_dtype}"
        assert unembed in record["k3_plans"], (unembed, record["k3_plans"])
        for k, plan in record["k3_plans"].items():
            (M, _K, N), dtype = map(int, k.split()[0].split("x")), k.split()[1]
            assert plan[0] == k3_path(M, N, getattr(torch, dtype)), (k, plan)
        assert stats.decoded_tokens > 0, stats.decoded_tokens
        assert stats.sample and all(0 <= t < vocab for t in stats.sample), stats.sample
        assert all(0 <= t < vocab for t in sess.last_tokens), "sampled id out of range"
        for name in _ATTN_KERNELS:
            if name in run["kernels"]:
                assert launches[name] > 0, f"{arch}: main path never launched {name}: " \
                                           f"{launches}"
            else:
                assert launches[name] == 0, f"{arch}: {name} launched: {launches}"
        d = dict(vars(stats))
        d["arch"] = cfg.name
        d["head_dim"] = cfg.head_dim
        d["passes"] = passes
        d["expected_a_prefill"], d["expected_a_decode_step"] = pre, dec
        d["k4_masks"] = record["k4_masks"]
        d["k3_shapes"] = record["k3_shapes"]
        d["k3_plans"] = record["k3_plans"]
        d["expert_dispatch"] = record["experts"]
        d["tok_s_card"] = f"{dev['kind']} ({dev['smi']})"
        d["serve_wall_s"] = wall
        d["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        d["launches"] = launches
        emit({"serve": d})
        for name in total:
            total[name] += launches[name]
        del sess
        torch.cuda.empty_cache()   # free this model before the next one is built
    return total


@contextlib.contextmanager
def plain_kernels():
    """Route ops' kernel entry points to the plain versions (the
    consistency checks only)."""
    saved = (ops.quant_matmul, ops.flash_attention, ops.flash_paged_decode,
             ops.sr_quantize_segments, ops.sr_quantize_segments_keyed, ops.sr_pack_keyed)

    def qmm(x, codes, scale):
        return qm.quant_matmul_plain(x, codes, scale)

    def attn(q, k, v, causal=True):
        return fa.flash_attention_plain(q, k, v, causal)

    def dec(q, kp, vp, pt, ln):
        return fa.flash_decode_plain(q, kp, vp, pt.to(torch.int32), ln.to(torch.int32))

    def srq(w, offsets, s, delta, u):
        return sq.sr_quant_segments_plain(w, offsets, s, delta, u)

    def srq_keyed(leaves, delta, key):
        return sq.sr_quant_segments_keyed_plain([x.reshape(-1) for x in leaves], delta, key)

    def pack_keyed(leaves, key, lim, dtype):
        return sq.sr_pack_keyed_plain(leaves, key, lim, dtype)

    (ops.quant_matmul, ops.flash_attention, ops.flash_paged_decode, ops.sr_quantize_segments,
     ops.sr_quantize_segments_keyed, ops.sr_pack_keyed) = (qmm, attn, dec, srq, srq_keyed,
                                                           pack_keyed)
    try:
        yield
    finally:
        (ops.quant_matmul, ops.flash_attention, ops.flash_paged_decode,
         ops.sr_quantize_segments, ops.sr_quantize_segments_keyed, ops.sr_pack_keyed) = saved


def prefilled(cfg, policy, *, seed: int = 0, batch: int = 4, s_max: int = 256,
              prompt_len: int = 128, page_size: int = 16, device: str = "cuda"):
    """Packed random weights of ``cfg`` (drawn with ``seed`` on ``device``)
    and caches (paged where the family pages) after one flash prefill of
    ``batch`` random prompts of ragged lengths, with the stub frontends'
    inputs the prefill takes (VLM images, enc-dec frames spanning
    ``s_max``) drawn normal.  A VLM's cross gates are set to 0.5 (drawn
    zero), so that the cross layers reach the logits.

    Returns ``(decode, prefill_logits, first_token, caches, again)``, where
    ``decode(token, caches) -> (logits, caches)`` runs one flash decode step
    and ``again()`` runs the same prefill once more (into the caches the
    last one left).  An enc-dec prefill's logits are ``None`` and its first
    token BOS.
    """
    from repro_torch.api.session import BOS_ID
    from repro_torch.core.quantization import default_exempt
    from repro_torch.dist.collectives import AxisCtx
    from repro_torch.launch.paging import SlotPager, set_page_tables
    from repro_torch.launch.steps import _compute_dtype, _greedy_pick, init_global_caches
    from repro_torch.models.common import ParamCtx, pack_params_for_policy
    from repro_torch.models.model import build_model

    axes, model = AxisCtx(), build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, 1, device=device)
    for name in ("periods/cross/gate", "periods/cross/mlp_gate"):
        if name in params:
            params[name].fill_(0.5)
    qparams = pack_params_for_policy(params, policy, exempt=default_exempt)
    del params
    cache_kw = {}
    if model.supports_paged_kv:
        pager = SlotPager.build(batch, s_max, page_size, batch * s_max // page_size)
        for slot in range(batch):
            pager.admit(slot, s_max)
        cache_kw = {"page_size": page_size, "pool_pages": pager.pool.n_pages}
    caches = init_global_caches(model, axes, s_max=s_max, batch_global=batch,
                                dtype=policy.kv_cache_dtype(), device=device, **cache_kw)
    if cache_kw:
        caches = set_page_tables(caches, pager.table)
    spec = model.prefill_batch_spec(batch, prompt_len, s_max)
    pf_batch = {name: torch.randn(tuple(t.shape), generator=gen, device=device)
                for name, t in spec.items() if name != "tokens"}
    if "tokens" in spec:
        pf_batch["tokens"] = torch.randint(2, cfg.vocab_size, (batch, prompt_len),
                                           generator=gen, device=device)
    plens = torch.tensor([prompt_len - 3 * s for s in range(batch)], dtype=torch.int32,
                         device=device)
    pc = ParamCtx.from_policy(axes, policy, compute_dtype=_compute_dtype(cfg))

    @torch.no_grad()
    def decode(token, caches):
        return model.decode_step(pc, qparams, {"token": token}, caches, attn_impl="flash")

    @torch.no_grad()
    def again():
        return model.prefill(pc, qparams, pf_batch, caches, attn_impl="flash",
                             prompt_lens=plens)

    lp, caches = again()
    tok = (torch.full((batch, 1), BOS_ID, dtype=torch.int32, device=device) if lp is None
           else _greedy_pick(axes, 1, cfg.vocab_size, lp))
    return decode, lp, tok, caches, again


def step_logits(cfg, policy, **kw) -> dict:
    """Logits of one flash prefill and one flash decode step of ``cfg``."""
    decode, lp, tok, caches, _again = prefilled(cfg, policy, **kw)
    ld, _ = decode(tok, caches)
    return {"prefill_logits": lp, "decode_logits": ld}


#: Throw-away kernels each profiler session opens with, and the host's wait
#: after them.  The trace loses the first device activities of a session:
#: on one H100, none in a fresh process and 5 of 64 after a minute of
#: matmuls (``torch.profiler`` with CUPTI, torch 2.11); by phases fl and
#: train once all of them and the first of the traced call's (an fl round's
#: keyed K1).
_PAD_KERNELS = 256
_PAD_WAIT_S = 0.2
_SPAN = "chip_smoke_span"
#: The marker kernel (``torch.cuda._sleep``) between the pads and the call.
_MARKER = "spin_kernel"


def _trace(fn):
    """``fn()`` under ``torch.profiler`` -> (the device events of ``fn``, all
    events, the span that brackets ``fn`` on the host).  The session opens
    with throw-away kernels, a synchronize and a wait on the host, then one
    marker kernel and a synchronize; ``fn``'s device activity is what starts
    after the marker on the device's clock (the host span's start, on the
    host's clock, is not comparable with it).  The marker must be in the
    trace, so that none of ``fn``'s activity was lost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(_PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(_PAD_WAIT_S)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with record_function(_SPAN):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == _SPAN and e.device_type == DeviceType.CPU)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != _SPAN]
    marker = [e.time_range.start for e in device if _MARKER in e.name]
    assert len(marker) == 1, f"the trace lost the marker kernel ({len(device)} device events)"
    return [e for e in device if e.time_range.start > marker[0]], events, span


def _by_name(device_events) -> dict:
    """``{name: [ms, count]}`` of device events (kernels, copies): an aten
    op's device time is its kernels' time again, so only device activity."""
    per: dict = {}
    for e in device_events:
        acc = per.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    return per


def _device_ms_by_name(fn, n: int) -> list:
    """``fn`` run ``n`` times under ``torch.profiler``: (device ms per run,
    launches per run, kernel name) of every device activity, largest first."""
    def run():
        for _ in range(n):
            fn()

    per_name = _by_name(_trace(run)[0])
    return sorted(((ms / n, c // n, name) for name, (ms, c) in per_name.items()), reverse=True)


def _launches(fn) -> dict:
    ops.reset_launches()
    fn()
    torch.cuda.synchronize()
    return dict(ops.LAUNCHES)


#: Device-activity name fragments of the serving kernels.
_KERNEL_NAMES = {"k3": "qmm_", "k4": "flash_attention_", "k5": "flash_decode"}


#: phase profile's models, their prompt lengths and depth cuts: the dense
#: serving path, the MoE one, the SSM one (its prefill is a loop of decode
#: steps, one 241-launch pass and ~92 ms of host a token, so a 16-token
#: prompt and one timed prefill), the enc-dec one (its prefill is the
#: encoder over 4 x 256 frames and the cross K/V; no prompt) and the VLM
#: one at phase serve's 2 periods
PROFILE_ARCHS = {"yi-6b": (128, {}), "olmoe-1b-7b": (128, {}), "mamba2-780m": (16, {}),
                 "seamless-m4t-large-v2": (64, {}),
                 "llama-3.2-vision-90b": (64, {"n_layers": 10})}


def phase_profile(dev: dict, measured: dict) -> None:
    """Where a full-depth decode step's and a prefill's time goes, for each
    of :data:`PROFILE_ARCHS`: host clock per step and per prefill, device
    time by kernel from ``torch.profiler``, K3's, K4's and K5's device time
    and launches (K3's by shape), and the rest of the device time.  Each
    step's device ms (and a decode step's slot lengths) go to ``measured``
    for phase ``roofline``."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy
    from repro_torch.configs import get_config

    for arch, (prompt_len, cut) in PROFILE_ARCHS.items():
        profile_arch(dev, dataclasses.replace(get_config(arch), **cut),
                     PrecisionPolicy.lazy_int8(7), prompt_len, measured)
        torch.cuda.empty_cache()


def _slot_lengths(caches) -> list | None:
    """The slots' cached lengths (layer 0 of the first cache with a
    ``length``), or None for a cache without one (SSM state)."""
    trees = caches.values() if isinstance(caches, dict) else [caches]
    for c in trees:
        if hasattr(c, "length"):
            n = c.length
            return (n[0] if n.ndim == 2 else n).tolist()
    return None


def profile_arch(dev: dict, cfg, policy, prompt_len: int = 128,
                 measured: dict | None = None) -> None:
    decode, _lp, tok, caches, again = prefilled(cfg, policy, prompt_len=prompt_len)
    state = {"tok": tok, "caches": caches}

    def step():
        logits, state["caches"] = decode(state["tok"], state["caches"])
        state["tok"] = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        state["tok"].cpu()                  # the serve loop syncs every step too

    def prefill_once():
        lp, caches = again()
        # the serve loop reads the first token (an enc-dec's is BOS: it
        # waits on the caches' merge instead)
        (lp.float().argmax(-1) if lp is not None else caches["cross_k"][0, 0, 0]).cpu()

    recurrent = cfg.family in ("ssm", "hybrid")
    out = {"arch": cfg.name, "card": f"{dev['kind']} ({dev['smi']})", "layers": cfg.n_layers,
           "batch": 4}
    prefill_label = ("prefill_4x256_frames" if cfg.family == "encdec"
                     else f"prefill_4x{prompt_len}")
    for label, fn, n, kind in (("decode_step", step, 8, "decode"),
                               (prefill_label, prefill_once, 1 if recurrent else 3,
                                "prefill")):
        for _ in range(1 if recurrent and kind == "prefill" else 2):   # warm up
            fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            fn()
        host_ms = (time.time() - t0) * 1e3 / n
        with k3_and_experts({}) as record:
            launches = _launches(fn)
        want = expected_launches(cfg, kind, prompt_len)
        assert {k: launches[k] for k in want} == want, f"{label}: {launches}, expected {want}"
        k3 = launches["quant_matmul"]
        lengths = _slot_lengths(state["caches"]) if kind == "decode" else None
        rows = _device_ms_by_name(fn, 1 if kind == "prefill" and recurrent else
                                  3 if kind == "decode" else 2)
        device_ms = sum(r[0] for r in rows)
        if measured is not None:
            measured[(cfg.name, kind)] = {"device_ms": device_ms if rows else None,
                                          "lengths": lengths, "prompt_len": prompt_len}
        out[label] = {
            "ms_host_clock": host_ms,
            "device_ms": device_ms if rows else "not measured",
            "device_busy_share": device_ms / host_ms if rows else "not measured",
            "device_ops": sum(r[1] for r in rows) if rows else "not measured"}
        for k, frag in _KERNEL_NAMES.items():
            out[label][f"{k}_device_ms"] = (sum(r[0] for r in rows if frag in r[2]) if rows
                                            else "not measured")
        if rows:
            out[label]["other_device_ms"] = device_ms - sum(
                out[label][f"{k}_device_ms"] for k in _KERNEL_NAMES)
            out[label]["k3_share"] = out[label]["k3_device_ms"] / device_ms
        out[label].update(k3_launches=k3, k4_launches=launches["flash_attention"],
                          k4_masks=record["k4_masks"],
                          k5_launches=launches["flash_decode"], k3_shapes=record["k3_shapes"],
                          k3_plans=record["k3_plans"], expert_dispatch=record["experts"],
                          top=[{"ms": ms, "launches": c, "name": k[:80]}
                               for ms, c, k in rows[:10]])
    emit({"profile": out})


#: phase consistency's models: (arch, depth cut, compute dtype, tolerance);
#: a cut of None runs the arch's smoke size.  f32 compute sends every
#: prefill through K4's split path and holds the kernels to the plain
#: versions far tighter than bf16 can.  qwen3-moe (128 experts, 64 heads over
#: 4 KV heads: K5 at G 16) runs in f32 so that both runs route every token
#: alike: bf16's differences between kernel and plain attention would move
#: tokens near a top-8 tie to another expert.  mamba2 (K3 only) and the
#: smoke-size jamba (K3, and K5 in its decode step) prefill as loops of
#: decode steps.  seamless-m4t at 2 + 2 layers in f32 sends its encoder
#: through K4's split path, non-causal at head dim 64 (its prefill has no
#: logits: the decode step's read the encoder through the cross K/V);
#: llama-3.2-vision at one period (a cross and 4 self layers) in bf16, its
#: cross gates non-zero (``prefilled``).
CONSISTENCY_RUNS = (("yi-6b", dict(n_layers=2), "bfloat16", 5e-2),
                    ("yi-6b", dict(n_layers=2), "float32", 2e-3),
                    ("gemma-7b", dict(n_layers=4), "bfloat16", 5e-2),
                    ("qwen3-moe-235b-a22b", dict(n_layers=2), "float32", 2e-3),
                    ("mamba2-780m", dict(n_layers=2), "float32", 2e-3),
                    ("jamba-1.5-large-398b", None, "float32", 2e-3),
                    ("seamless-m4t-large-v2", dict(n_layers=2, n_encoder_layers=2), "float32",
                     2e-3),
                    ("llama-3.2-vision-90b", dict(n_layers=5), "bfloat16", 5e-2))


def phase_consistency() -> None:
    """One prefill and one decode step's logits, kernels against plain
    versions, for each of :data:`CONSISTENCY_RUNS`; then the smoke-size
    serve."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy
    from repro_torch.configs import get_config, smoke_variant

    for arch, cut, compute, tol in CONSISTENCY_RUNS:
        cfg = (dataclasses.replace(get_config(arch), **cut, compute_dtype=compute)
               if cut else dataclasses.replace(smoke_variant(get_config(arch)),
                                               compute_dtype=compute))
        # the recurrent families prefill a token at a time: a shorter prompt
        prompt_len = 32 if cfg.family in ("ssm", "hybrid") else 128
        runs = {}
        for label, ctx in (("kernels", contextlib.nullcontext()), ("plain", plain_kernels())):
            ops.reset_launches()
            with ctx:
                runs[label] = step_logits(cfg, PrecisionPolicy.lazy_int8(7),
                                          prompt_len=prompt_len)
            torch.cuda.synchronize()
            if label == "kernels":      # one prefill and one decode step
                launches = dict(ops.LAUNCHES)
                pre = expected_launches(cfg, "prefill", prompt_len)
                dec = expected_launches(cfg, "decode", prompt_len)
                want = {k: pre[k] + dec[k] for k in pre}
                assert {k: launches[k] for k in want} == want, (launches, want)
        agree, diff = {}, {}
        for key in ("prefill_logits", "decode_logits"):
            if runs["kernels"][key] is None:        # an enc-dec prefill
                assert runs["plain"][key] is None, key
                continue
            a, b = runs["kernels"][key].float(), runs["plain"][key].float()
            assert a.shape == (4, 1, cfg.vocab_size) and torch.isfinite(a).all(), key
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
            agree[key] = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            diff[key] = float((a - b).abs().max())
        emit({"consistency": {"arch": cfg.name, "layers": cfg.n_layers,
                              "encoder_layers": cfg.n_encoder_layers,
                              "d_model": cfg.d_model, "head_dim": cfg.head_dim,
                              "decode_group": (cfg.n_heads // cfg.n_kv_heads
                                               if cfg.n_kv_heads else None),
                              "experts": cfg.n_experts,
                              "k3_launches": launches["quant_matmul"],
                              "k4_launches": launches["flash_attention"],
                              "k5_launches": launches["flash_decode"],
                              "compute_dtype": compute, "tol": tol,
                              "max_abs_diff": diff, "greedy_agreement": agree}})
        del runs
        torch.cuda.empty_cache()
    smoke_serve()


def smoke_serve() -> None:
    """``Session.serve`` of the smoke-size yi-6b (f32 compute, head dim 16,
    int8 weights, paged KV, ``attn_impl="flash"``) on the card: every
    request completes and every K4 launch is planned onto the split path
    (the plans are recorded as ``flash_attention_cuda`` asks for them).
    Then K4 at each shape the serve launched it with, on seeded inputs:
    within 2e-4 of the plain version and bit-equal over two launches."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session

    spec = RunSpec("yi-6b", workload="serve", smoke=True, seed=0, batch=4, seq=64,
                   precision=PrecisionPolicy.lazy_int8(7),
                   options={"attn_impl": "flash", "kv_layout": "paged", "prompt_len": 16,
                            "requests": 4, "max_new": 6, "steps": 24, "vary_prompt": True,
                            "quiet": True})
    sess = Session(spec, device="cuda")
    plan, calls = fa.plan_attention, []

    def recording_plan(*args):
        p = plan(*args)
        calls.append((args, p.path))
        return p

    fa.plan_attention = recording_plan
    try:
        ops.reset_launches()
        stats = sess.serve()
        launches = dict(ops.LAUNCHES)
    finally:
        fa.plan_attention = plan
    paths = [path for _, path in calls]
    assert sess.cfg.compute_dtype == "float32" and sess.cfg.head_dim == 16, sess.cfg
    assert stats.admitted == stats.completed == 4, stats
    assert launches["flash_attention"] > 0 and launches["flash_attention"] == len(paths), \
        (launches, paths)
    assert set(paths) == {"wgmma_split"}, paths
    for name in ("quant_matmul", "flash_decode"):
        assert launches[name] > 0, f"smoke serve never launched {name}: {launches}"
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes, errs = sorted({args[:5] for args, _ in calls}, key=str), []
    for BH, S, D, dtype, causal in shapes:
        q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = fa.flash_attention_cuda(q, k, v, causal)
        again = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        case = f"smoke serve's K4 BH={BH} S={S} D={D} {dtype} causal={causal}"
        _check(case, got, want, 2e-4, 2e-4)
        if not torch.equal(got, again):
            raise AssertionError(f"{case}: two launches on identical inputs differ")
        errs.append(max_errs(got, want)[0])
    emit({"smoke_serve": {"arch": sess.cfg.name, "head_dim": sess.cfg.head_dim,
                          "compute_dtype": sess.cfg.compute_dtype, "admitted": stats.admitted,
                          "completed": stats.completed, "k4_paths": sorted(set(paths)),
                          "k4_shapes": [dict(BH=a[0], S=a[1], D=a[2], dtype=str(a[3]),
                                             causal=a[4], max_abs_err=e)
                                        for a, e in zip(shapes, errs)],
                          "launches": launches}})


FL_SPECS = {
    # examples/quickstart.py
    "quickstart-mobilenet": dict(arch="mobilenet", rounds=10, batch=16,
                                 options={"scheme": "fwq", "n_clients": 8, "lr": 0.08}),
    # the resnet cells of the fl-codesign-grid sweep preset (fwq scheme)
    "codesign-resnet": dict(arch="resnet", rounds=10, batch=16,
                            options={"scheme": "fwq", "n_clients": 8, "lr": 0.2,
                                     "error_tolerance": 4.5, "eval_every": 10}),
}


def _same(a, b) -> bool:
    """Exact equality of nested host values (arrays, dicts, policies)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "to_dict"):
        return a.to_dict() == b.to_dict()
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool((a == b).all())


@contextlib.contextmanager
def round_clock(rows: list):
    """Per round: host-clock seconds of planning (channel draw, GBD
    co-design, energy model) and of training (data to the card, K1, the
    clients' gradients, the server step, the loss back), and K1 calls (all
    entries, and the keyed segment entry's)."""
    from repro_torch.fed.orchestrator import FLOrchestrator
    from repro_torch.fed.simulation import FLSimulation

    plan, run = FLOrchestrator.plan_round, FLSimulation.run_round

    def timed_plan(self, r):
        t0 = time.perf_counter()
        out = plan(self, r)
        rows.append({"round": r, "t0": t0, "plan_s": time.perf_counter() - t0})
        return out

    def timed_run(self, *a, **kw):
        k0, t0 = ops.LAUNCHES["sr_quant"], time.perf_counter()
        kk = ops.LAUNCHES["sr_quant_keyed"]
        out = run(self, *a, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows[-1].update(train_s=t1 - t0, round_s=t1 - rows[-1].pop("t0"),
                        k1_launches=ops.LAUNCHES["sr_quant"] - k0,
                        k1_keyed_launches=ops.LAUNCHES["sr_quant_keyed"] - kk)
        return out

    FLOrchestrator.plan_round, FLSimulation.run_round = timed_plan, timed_run
    try:
        yield
    finally:
        FLOrchestrator.plan_round, FLSimulation.run_round = plan, run


def _fl_sim(device: str, n_clients: int = 8):
    """The quickstart's mobilenet FLSimulation and its round-0 batch."""
    from repro_torch.data import ClientBatcher, SyntheticImages, dirichlet_partition
    from repro_torch.fed.simulation import FLSimulation, SimConfig
    from repro_torch.models import cnn

    model = cnn.mobilenet(width=8, n_stages=2)
    sim = FLSimulation(cnn.xent_loss(model), model.init,
                       SimConfig(n_clients=n_clients, lr=0.08, seed=0), device=device)
    imgs, labels = SyntheticImages(n=2048, hw=16, seed=0).generate()
    parts = dirichlet_partition(labels, n_clients, alpha=0.5, seed=0)
    x, y = ClientBatcher(imgs, labels, parts, batch=16, seed=0).sample_round(
        0, np.arange(n_clients))
    return sim, {"x": torch.as_tensor(x, device=device), "y": torch.as_tensor(y, device=device)}


FL_BITS = np.array([16, 8, 16, 16, 16, 8, 8, 16])     # the quickstart's GBD choice


def check_fl_round(device: str = "cuda") -> None:
    """One FWQ round from the same parameters and the same key, through K1's
    keyed entry and through the plain version on the card, and on the CPU
    through the u-taking path fed ``round_uniforms``' tensor (the keyed
    draws, so the round is the same)."""
    from repro_torch.core.fwq import delta_for_clients
    from repro_torch.core.quantization import quantize_clients

    sim, batch = _fl_sim(device)
    bits = FL_BITS
    u = sim.round_uniforms(0, len(bits))
    delta = delta_for_clients(bits).to(device)
    key = sim.round_key(0)
    q_kernel = quantize_clients(sim.params, delta, key=key)
    q_given = quantize_clients(sim.params, delta, u)
    with plain_kernels():
        q_plain = quantize_clients(sim.params, delta, key=key)
    for p, q in q_kernel.items():
        if not (torch.equal(q, q_plain[p]) and torch.equal(q, q_given[p])):
            raise AssertionError(f"fl round: K1's keyed {p} differs from the plain version's "
                                 "or from the u-taking entry fed round_uniforms")
    start = {k: v.clone() for k, v in sim.params.items()}
    after, losses = {}, {}
    for label, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_kernels())):
        params = {k: v.clone() for k, v in start.items()}
        sim.load_state({"params": params, "opt": sim.opt.init(params)}, 0)
        with ctx:
            losses[label] = sim.run_round(batch, bits)["loss"]
        after[label] = sim.params
    cpu_sim, _ = _fl_sim("cpu")
    cpu_params = {k: v.cpu() for k, v in start.items()}
    cpu_sim.load_state({"params": cpu_params, "opt": cpu_sim.opt.init(cpu_params)}, 0)
    cpu_sim.round_uniforms = lambda r, n: u.cpu()
    losses["cpu"] = cpu_sim.run_round({k: v.cpu() for k, v in batch.items()}, bits)["loss"]
    after["cpu"] = {k: v.to(device) for k, v in cpu_sim.params.items()}
    err = {}
    for label in ("plain", "cpu"):
        for k, v in after["kernel"].items():
            torch.testing.assert_close(v, after[label][k], rtol=1e-5, atol=1e-5)
        err[label] = max(float((v - after[label][k]).abs().max())
                         for k, v in after["kernel"].items())
    out = {"quantized_bit_equal": True, "keyed_equals_round_uniforms": True, "tol": 1e-5,
           "losses": losses, "max_abs_param_diff": err}
    emit({"fl_round_kernel_vs_plain": out})


def profile_fl_round(dev: dict, gbd_s: list, device: str = "cuda") -> None:
    """Where one round's time goes: host clock of the training part, and the
    device time by kernel and copy from ``torch.profiler``."""
    sim, batch = _fl_sim(device)
    for _ in range(2):                                   # warm up
        sim.run_round(batch, FL_BITS)
    n, t0 = 5, time.perf_counter()
    for _ in range(n):
        sim.run_round(batch, FL_BITS)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / n
    # the quantization step alone: K1's keyed entry, and the parent's chain
    from repro_torch.core.fwq import delta_for_clients

    delta = delta_for_clients(FL_BITS).to(device)
    quant_ms = time_events_ms(keyed_fl_quantize, (sim.params, delta, sim.round_key(0)), n)
    earlier_ms = time_events_ms(earlier_fl_quantize, (sim.params, delta, 0, 0), n)
    k1_calls = ops.LAUNCHES["sr_quant_keyed"]
    per = _by_name(_trace(lambda: sim.run_round(batch, FL_BITS))[0])
    k1_calls = ops.LAUNCHES["sr_quant_keyed"] - k1_calls
    device_ms = sum(v[0] for v in per.values())
    k1_kernels = {k: v for k, v in per.items() if "sr_quant" in k or "seg_absmax" in k}
    k1 = sum(v[0] for v in k1_kernels.values())
    # one keyed K1 call a round, its two passes in the trace
    assert k1_calls == 1 and sum(v[1] for v in k1_kernels.values()) == 2 and k1 > 0, \
        (k1_calls, k1_kernels)
    rand = sum(v[1] for k, v in per.items() if "uniform" in k.lower() or "philox" in k.lower())
    copies = sum(v[0] for k, v in per.items() if "memcpy" in k.lower())
    n_copy = sum(v[1] for k, v in per.items() if "memcpy" in k.lower())
    rows = sorted(((v[0], v[1], k) for k, v in per.items()), reverse=True)
    emit({"fl_profile": {
        "card": f"{dev['kind']} ({dev['smi']})", "model": "mobilenet", "clients": 8,
        "batch": 16, "train_ms_host_clock": train_ms, "quantize_ms_host_clock": quant_ms,
        "earlier_quantize_ms_host_clock": earlier_ms, "rand_launches": rand,
        "gbd_solve_s_host_clock": gbd_s,
        "device_ms": device_ms if rows else "not measured",
        "device_busy_share": device_ms / train_ms if rows else "not measured",
        "k1_ms": k1, "k1_keyed_calls": k1_calls, "k1_kernels": [k[:70] for k in k1_kernels],
        "memcpy_ms": copies, "memcpy_count": n_copy,
        "kernel_launches": sum(v[1] for v in per.values()),
        "top": [{"ms": ms, "count": c, "name": k[:70]} for ms, c, k in rows[:10]]}})


def phase_fl(dev: dict, device: str = "cuda") -> dict:
    """The paper's loop on the card; returns its K1 calls (all entries, and
    the keyed segment entry's)."""
    from repro_torch.api import RunSpec, Session

    outs, clocks = {}, {}
    ops.reset_launches()
    for name, spec in FL_SPECS.items():
        rows: list = []
        t0 = time.time()
        with round_clock(rows):
            out = Session(RunSpec(workload="fl-sim", seed=0, **spec), device=device).run()
        wall = time.time() - t0
        hist, elog = out["history"], out["energy_log"]
        assert len(hist) == spec["rounds"] == len(rows), (len(hist), len(rows))
        for h, e, r in zip(hist, elog, rows):
            assert np.isfinite(h["loss"]) and np.isfinite(h["client_loss"]).all(), h
            assert r["k1_launches"] == r["k1_keyed_launches"] == 1, \
                f"{name} round {h['round']}: {r}"
            print(f"fl {name} round {h['round']}: loss {h['loss']:.4f} energy "
                  f"{e['energy_round']:.3f} J bits {sorted(set(h['bits'].tolist()))} "
                  f"cohort {h['cohort_size']} host {r['round_s'] * 1e3:.1f} ms "
                  f"(plan {r['plan_s'] * 1e3:.1f}, train {r['train_s'] * 1e3:.1f}) "
                  f"K1 launches {r['k1_launches']}")
        assert hist[-1]["loss"] < hist[0]["loss"], [h["loss"] for h in hist]
        emit({"fl": {"spec": name, "card": f"{dev['kind']} ({dev['smi']})",
                     "rounds": len(hist), "wall_s": wall,
                     "total_energy_j": out["total_energy_j"],
                     "total_time_s_simulated": out["total_time_s"],
                     "losses": [h["loss"] for h in hist], "evals": out["evals"],
                     "round_s": [r["round_s"] for r in rows],
                     "plan_s": [r["plan_s"] for r in rows],
                     "train_s": [r["train_s"] for r in rows]}})
        outs[name], clocks[name] = out, rows
    launches = dict(ops.LAUNCHES)
    n_rounds = sum(spec["rounds"] for spec in FL_SPECS.values())
    assert launches["sr_quant"] == launches["sr_quant_keyed"] == n_rounds, launches

    # the host math (channel, GBD, energy, cohorts) is the CPU's: a CPU run
    # of the same spec must plan the first rounds exactly alike
    for name, spec in FL_SPECS.items():
        cpu = Session(RunSpec(workload="fl-sim", seed=0, **{**spec, "rounds": 3}),
                      device="cpu").run()
        for r in range(3):
            g, c = outs[name]["energy_log"][r], cpu["energy_log"][r]
            gh, ch = outs[name]["history"][r], cpu["history"][r]
            if not (_same(g, c) and _same(gh["bits"], ch["bits"])
                    and gh["cohort_size"] == ch["cohort_size"]):
                raise AssertionError(f"fl {name} round {r}: the card's run planned "
                                     "differently from the CPU run")
        print(f"fl {name}: energy log, bits and cohorts of rounds 0-2 equal the CPU run's")
    check_fl_round(device)
    # rounds 0 and 5 re-solve the co-design (resolve_every = 5)
    gbd_s = [r["plan_s"] for rows in clocks.values() for r in rows if r["round"] % 5 == 0]
    profile_fl_round(dev, gbd_s, device)
    return {k: launches[k] for k in ("sr_quant", "sr_quant_keyed")}


TRAIN_RUNS = {
    # the paper's loop on the pod trainer, comm 8 -> int16 codes.  Scheme
    # unified_q (16 bits a client, bandwidth and energy by the co-design's
    # primal): the fleet's 8-64 MB device memories hold no bit-width of a
    # 1.9 B-parameter model, so fwq's GBD (and rand_q) have no feasible
    # point here, in the reference as in the port (ROADMAP §3)
    "fl-orchestrate": dict(workload="fl-orchestrate", rounds=3,
                           precision=dict(comm=8), options={"scheme": "unified_q"}),
    # fixed 8-bit weights, comm 4 -> int8 codes (4 x 15 = 60)
    "train": dict(workload="train", rounds=2, precision=dict(weights=8, comm=4),
                  options={}),
}


def _train_session(run: dict, device: str, arch: str = "yi-6b", layers: int = 8,
                   seq: int = 512, mesh: str = "4x1", **cut):
    """A Session of ``arch`` at full width with the depth cut to ``layers``
    (and ``cut``'s other keys: an encoder's depth) as phase ``consistency``
    cuts its model, on a 4x1 mesh (or ``mesh``): 4 clients, batch 2 each,
    sequence ``seq``, lr 0.05."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.configs import get_config

    spec = RunSpec(arch, workload=run["workload"], mesh=mesh, smoke=False, seed=0,
                   batch=2, seq=seq, rounds=run["rounds"],
                   precision=PrecisionPolicy(**run["precision"]),
                   options={"lr": 0.05, "quiet": True, **run["options"]})
    sess = Session(spec, device=device)
    sess.cfg = dataclasses.replace(get_config(arch), n_layers=layers, **cut)
    return sess


@contextlib.contextmanager
def train_clock(rows: list):
    """Per round of the pod trainer: host-clock planning (the orchestrator)
    and step time, K1/K2 launches, peak device memory; and the last K2 call's
    inputs (a step's real replicated gradients and the wire's key), copied."""
    from repro_torch.api.session import Session
    from repro_torch.fed.orchestrator import FLOrchestrator

    plan, fl_round, pack = FLOrchestrator.plan_round, Session.fl_round, ops.sr_pack_keyed
    inline = ops.sr_quantize_inline

    def timed_plan(self, r):
        t0 = time.perf_counter()
        out = plan(self, r)
        rows[-1]["plan_s"] = time.perf_counter() - t0
        return out

    def timed_round(self, r):
        torch.cuda.reset_peak_memory_stats()
        rows.append({"round": r, "plan_s": 0.0})
        k1, k1i = ops.LAUNCHES["sr_quant"], ops.LAUNCHES["sr_quant_inline"]
        k2, k2k = ops.LAUNCHES["sr_pack"], ops.LAUNCHES["sr_pack_keyed"]
        t0 = time.perf_counter()
        rec = fl_round(self, r)
        torch.cuda.synchronize()
        rows[-1].update(round_s=time.perf_counter() - t0,
                        k1_launches=ops.LAUNCHES["sr_quant"] - k1,
                        k1_inline_launches=ops.LAUNCHES["sr_quant_inline"] - k1i,
                        k2_launches=ops.LAUNCHES["sr_pack"] - k2,
                        k2_keyed_launches=ops.LAUNCHES["sr_pack_keyed"] - k2k,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows[-1]["step_s"] = rows[-1]["round_s"] - rows[-1]["plan_s"]
        return rec

    def recording_pack(leaves, key, lim, dtype):
        rows[-1]["k2_args"] = ([[g.clone() for g in leaf] for leaf in leaves], key, lim, dtype)
        return pack(leaves, key, lim, dtype)

    def recording_inline(w, delta, key, out_dtype):
        # the first round's first 4096 x 11008 weight use (an MLP matrix),
        # kept on the host so that the peak memory is the step's own
        if len(rows) == 1 and "k1_args" not in rows[0] and w.numel() == 4096 * 11008:
            rows[0]["k1_args"] = (w.cpu(), delta.cpu(), key, out_dtype)
        return inline(w, delta, key, out_dtype)

    FLOrchestrator.plan_round, Session.fl_round = timed_plan, timed_round
    ops.sr_pack_keyed, ops.sr_quantize_inline = recording_pack, recording_inline
    try:
        yield
    finally:
        FLOrchestrator.plan_round, Session.fl_round = plan, fl_round
        ops.sr_pack_keyed, ops.sr_quantize_inline = pack, inline


_SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _syncs_in(events, span) -> list:
    return [e.name for e in events if e.name in _SYNC_EVENTS
            and span.start <= e.time_range.start <= span.end]


def _host_syncs(fn) -> list:
    """Host waits on the card (synchronize calls) made inside ``fn``: the
    profiler's own synchronizes and ``_trace``'s fall outside the span that
    brackets the call."""
    _mine, events, span = _trace(fn)
    return _syncs_in(events, span)


def profile_train_round(dev: dict, sess, r: int) -> dict:
    """Where one warm train round's time goes: host clock, and the device
    time by kernel family from ``torch.profiler`` (an extra round, after the
    counted ones); the host syncs are the round's own and its closing
    synchronize."""
    clock = {}

    def round_():
        t0 = time.perf_counter()
        sess.fl_round(r)
        torch.cuda.synchronize()
        clock["host_ms"] = (time.perf_counter() - t0) * 1e3

    k1 = ops.LAUNCHES["sr_quant"]
    mine, events, span = _trace(round_)
    host_ms = clock["host_ms"]
    k1 = ops.LAUNCHES["sr_quant"] - k1
    per = _by_name(mine)
    syncs: dict = {}
    for name in _syncs_in(events, span):
        syncs[name] = syncs.get(name, 0) + 1
    # K1's family takes every entry's kernels (the inline entry's two
    # passes), K2's both entries' (the keyed entry's two passes); the names
    # of trees before the inline entry ran the keyed kernels are kept, so
    # that --src=DIR reads a parent alike
    families = {"K1 sr_quant": ("sr_quant_kernel", "sr_quant_inline", "sr_absmax",
                                "sr_quant_keyed", "seg_absmax_kernel<false"),
                "K2 sr_pack": ("sr_pack_kernel", "sr_pack_keyed", "seg_absmax_kernel<true"),
                "matmul (cuBLAS)": ("gemm", "xmma", "cutlass", "cublas", "nvjet"),
                "uniforms (Philox)": ("philox", "uniform", "distribution"),
                "abs": ("absfunctor",),
                "copies": ("memcpy", "memset")}
    fam: dict = {}
    for name, (ms, n) in per.items():
        key = next((f for f, keys in families.items()
                    if any(k in name.lower() for k in keys)), "other (elementwise, "
                   "reductions, softmax, casts)")
        acc = fam.setdefault(key, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    device_ms = sum(v[0] for v in per.values())
    rows = sorted(((v[0], v[1], k) for k, v in per.items()), reverse=True)
    out = {"train_profile": {
        "card": f"{dev['kind']} ({dev['smi']})", "round": r, "host_ms": host_ms,
        "device_ms": device_ms if rows else "not measured",
        "device_busy_share": device_ms / host_ms if rows else "not measured",
        "device_ops": sum(v[1] for v in per.values()), "k1_launches": k1,
        "host_syncs": syncs,
        "families": {k: {"ms": v[0], "count": v[1]} for k, v in
                     sorted(fam.items(), key=lambda kv: -kv[1][0])},
        "top": [{"ms": ms, "count": c, "name": k[:70]} for ms, c, k in rows[:12]]}}
    emit(out)
    return out["train_profile"]


def phase_train(dev: dict, measured: dict | None = None) -> dict:
    """The pod trainer on the card; returns its K1 and K2 launches.  The
    ``train`` run's profiled step (device ms) and peak memory go to
    ``measured`` for phase ``roofline``."""
    from repro_torch.core.quantization import FULL_PRECISION_BITS

    launches = {"sr_quant": 0, "sr_quant_inline": 0, "sr_pack": 0, "sr_pack_keyed": 0}
    k2_inputs = None
    for name, run in TRAIN_RUNS.items():
        rows: list = []
        sess = _train_session(run, "cuda")
        t0 = time.time()
        sess._ensure_train_state()          # set-up: weights, tokens, planner
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        ops.reset_launches()
        t0 = time.time()
        with train_clock(rows):
            hist = sess.run_train()
        wall = time.time() - t0
        got = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += got[k]
        assert sess.cfg.n_layers == 8 and sess.cfg.d_model == 4096, sess.cfg
        assert len(hist) == run["rounds"] == len(rows), (len(hist), len(rows))
        comm = int(run["precision"]["comm"])
        # a weight use is one K1 launch (the inline entry): embed and unembed
        # once, the 7 block weights of each layer twice (remat reruns them)
        uses = 4 * (2 + 7 * sess.cfg.n_layers * (2 if sess.cfg.remat else 1))
        assert uses == 456, uses
        for h, r in zip(hist, rows):
            assert np.isfinite(h["loss"]), h
            assert h["comm_bits"] == comm < FULL_PRECISION_BITS, h
            # one call of K2's keyed entry a step packs every (client, wire
            # leaf) segment
            assert r["k2_launches"] == r["k2_keyed_launches"] == 1, \
                f"{name} round {h['round']}: {r}"
            assert r["k1_launches"] == r["k1_inline_launches"] == uses, (uses, r)
            print(f"train {name} round {h['round']}: loss {h['loss']:.4f} bits "
                  f"{sorted(set(h['bits']))} energy {h['energy_j']:.3f} J cohort "
                  f"{h['cohort']} plan {r['plan_s'] * 1e3:.1f} ms step "
                  f"{r['step_s'] * 1e3:.1f} ms K1 launches {r['k1_launches']} K2 launches "
                  f"{r['k2_launches']} peak {r['peak_mem_gb']:.2f} GB")
        # one weight use of the run, through the inline K1 and its plain version
        w, d, k, od = (a.cuda() if torch.is_tensor(a) else a for a in rows[0].pop("k1_args"))
        if not torch.equal(sq.sr_quant_inline_cuda(w, d, k, od),
                           sq.sr_quant_inline_plain(w, d, k, od)):
            raise AssertionError(f"train {name}: the inline K1 differs from the plain version "
                                 f"on a {tuple(w.shape)} weight use")
        print(f"train {name}: inline K1 bit-equal to the plain version on a {tuple(w.shape)} "
              f"weight use ({od}, delta {float(d):.3g}); {uses} K1 launches a step")
        del w
        k2_args = rows[-1]["k2_args"]
        want_dtype = torch.int16 if comm == 8 else torch.int8
        assert k2_args[-1] == want_dtype, (name, k2_args[-1])
        assert [[g.numel() for g in leaf] for leaf in k2_args[0]] == \
            [[n] * 4 for n in TRAIN_WIRE_SIZES], "the wire's leaves"
        if name == "fl-orchestrate":
            k2_inputs = k2_args
            orch_log = sess._train_state["orch"].energy_log
        emit({"train": {
            "run": name, "card": f"{dev['kind']} ({dev['smi']})", "layers": 8,
            "d_model": 4096, "mesh": "4x1", "batch_per_client": 2, "seq": 512,
            "comm_bits": comm, "wire_codes": str(want_dtype), "setup_s": setup_s,
            "wall_s": wall,
            "losses": [h["loss"] for h in hist], "launches": got,
            "comm_report": {k: v for k, v in sess.comm_report().items() if k != "rounds"},
            "rounds": [{k: v for k, v in r.items() if k != "k2_args"} for r in rows]}})
        if name == "train":
            prof = profile_train_round(dev, sess, run["rounds"])
            if measured is not None:
                measured[("yi-6b", "train")] = {
                    "device_ms": prof["device_ms"] if prof["device_ms"] != "not measured"
                    else None, "peak_gb": max(r["peak_mem_gb"] for r in rows)}
            # the wire draws in K2: no uniform-drawing kernel, K2's two passes
            fams = prof["families"]
            assert "uniforms (Philox)" not in fams, fams
            assert fams["K2 sr_pack"]["count"] == 2, fams
        del sess, rows
        torch.cuda.empty_cache()
    # K2's keyed entry on a step's real replicated gradients (outside the
    # counted runs): codes, pitch and non-finite count
    leaves, key, lim, dtype = k2_inputs
    _same_pack("on a step's wire", sq.sr_pack_keyed_cuda(leaves, key, lim, dtype),
               sq.sr_pack_keyed_plain(leaves, key, lim, dtype))
    print(f"train: keyed K2 bit-equal to the plain version on a step's wire ({len(leaves[0])} "
          f"clients, {len(leaves)} leaves of {[g.numel() for g in leaves[0]]}, {dtype})")
    # the wire ("raise", as the trainer runs it) waits on the host once: the count
    waits = _host_syncs(lambda: keyed_wire(leaves, key, lim.bit_length()))
    assert len(waits) <= 1, f"the keyed wire waited on the card: {waits}"
    print(f"train: the keyed wire waits on the card {len(waits)} time(s) {waits} (the "
          "non-finite count)")
    # the host math (channel, GBD, energy, cohorts) is the CPU's: the same
    # orchestrator planned on the CPU must give the same rounds
    cpu_orch = _train_session(TRAIN_RUNS["fl-orchestrate"], "cpu").orchestrator(4)
    for r, g_rec in enumerate(orch_log):
        c_rec = cpu_orch.plan_round(r)
        if not _same({k: v for k, v in g_rec.items() if k != "policy"},
                     {k: v for k, v in c_rec.items() if k != "policy"}) or \
                g_rec["policy"].to_dict() != c_rec["policy"].to_dict():
            raise AssertionError(f"train fl-orchestrate round {r}: the card's run "
                                 "planned differently from the CPU run")
    print(f"train fl-orchestrate: plans of rounds 0-{len(orch_log) - 1} (bits, energy, "
          "cohorts) equal the CPU run's")
    for k, n in train_moe(dev).items():
        launches[k] += n
    for k, n in train_mamba2(dev).items():
        launches[k] += n
    for k, n in train_seamless(dev).items():
        launches[k] += n
    return launches


def train_moe(dev: dict) -> dict:
    """The ``train`` run (8-bit weights, int8 wire) on olmoe-1b-7b at full
    width cut to 2 layers, 4x1 mesh, batch 2, sequence 256: finite losses,
    one inline K1 launch a weight use (each expert stack one weight use;
    the router exempt), one call of K2's keyed entry a step (the wire's
    replicated leaves: the norms and the routers), the peak memory, and a
    profiled round.  Returns its K1 and K2 launches."""
    run = TRAIN_RUNS["train"]
    rows: list = []
    sess = _train_session(run, "cuda", arch="olmoe-1b-7b", layers=2, seq=256)
    cfg = sess.cfg
    t0 = time.time()
    sess._ensure_train_state()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    record: dict = {}
    ops.reset_launches()
    t0 = time.time()
    with train_clock(rows), k3_and_experts(record):
        hist = sess.run_train()
    wall = time.time() - t0
    got = dict(ops.LAUNCHES)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts) == (2, 2048, 64), cfg
    # a weight use: embed, unembed, and q, k, v, o and the three expert
    # stacks a layer, twice under remat
    uses = 4 * (2 + 7 * cfg.n_layers * (2 if cfg.remat else 1))
    wire = rows[-1]["k2_args"][0]
    for h, r in zip(hist, rows):
        assert np.isfinite(h["loss"]), h
        assert r["k2_launches"] == r["k2_keyed_launches"] == 1, r
        assert r["k1_launches"] == r["k1_inline_launches"] == uses, (uses, r)
        # 1.05 B parameters held whole with 4 clients' gradients (22.5 GB
        # on one H100): half the card is the bound
        assert r["peak_mem_gb"] < 40, r
        print(f"train olmoe round {h['round']}: loss {h['loss']:.4f} step "
              f"{r['step_s'] * 1e3:.1f} ms K1 launches {r['k1_launches']} K2 launches "
              f"{r['k2_launches']} peak {r['peak_mem_gb']:.2f} GB")
    # the wire's leaves: ln1, ln2, the router stacks, the final norm
    assert [leaf[0].numel() for leaf in wire] == [2 * 2048, 2 * 2048, 2 * 2048 * 64, 2048], \
        [leaf[0].numel() for leaf in wire]
    # the trainer's expert stacks are the quantized bf16 weights: einsum
    assert set(record["experts"]) == {"plain"}, record
    prof = profile_train_round(dev, sess, run["rounds"])
    emit({"train": {
        "run": "train", "arch": cfg.name, "card": f"{dev['kind']} ({dev['smi']})",
        "layers": cfg.n_layers, "d_model": cfg.d_model, "experts": cfg.n_experts,
        "mesh": "4x1", "batch_per_client": 2, "seq": 256, "comm_bits": 4,
        "wire_codes": str(rows[-1]["k2_args"][-1]), "setup_s": setup_s, "wall_s": wall,
        "losses": [h["loss"] for h in hist], "launches": got, "k1_uses_a_step": uses,
        "device_ms": prof["device_ms"],
        "comm_report": {k: v for k, v in sess.comm_report().items() if k != "rounds"},
        "rounds": [{k: v for k, v in r.items() if k != "k2_args"} for r in rows]}})
    del sess, rows, wire
    torch.cuda.empty_cache()
    return {k: got[k] for k in ("sr_quant", "sr_quant_inline", "sr_pack", "sr_pack_keyed")}


def train_mamba2(dev: dict) -> dict:
    """The ``train`` run (8-bit weights, int8 wire) on mamba2-780m at full
    width cut to 8 layers, 4x1 mesh, batch 2, sequence 512 (two SSD chunks of
    256): finite losses, one inline K1 launch a weight use (wx, wz, w_bc,
    w_dt, wo a layer, twice under remat, and the embed and unembed; the
    recurrence vectors, conv kernels and norms exempt), one call of K2's
    keyed entry a step, the peak memory, and a profiled round.  Returns its
    K1 and K2 launches."""
    run = TRAIN_RUNS["train"]
    rows: list = []
    sess = _train_session(run, "cuda", arch="mamba2-780m", layers=8, seq=512)
    cfg = sess.cfg
    t0 = time.time()
    sess._ensure_train_state()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    ops.reset_launches()
    t0 = time.time()
    with train_clock(rows):
        hist = sess.run_train()
    wall = time.time() - t0
    got = dict(ops.LAUNCHES)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_chunk, cfg.remat) == (8, 1536, 256, True), cfg
    uses = 4 * (2 + 5 * cfg.n_layers * 2)
    assert uses == 328, uses
    wire = rows[-1]["k2_args"][0]
    for h, r in zip(hist, rows):
        assert np.isfinite(h["loss"]), h
        assert r["k2_launches"] == r["k2_keyed_launches"] == 1, r
        assert r["k1_launches"] == r["k1_inline_launches"] == uses, (uses, r)
        print(f"train mamba2 round {h['round']}: loss {h['loss']:.4f} step "
              f"{r['step_s'] * 1e3:.1f} ms K1 launches {r['k1_launches']} K2 launches "
              f"{r['k2_launches']} peak {r['peak_mem_gb']:.2f} GB")
    # K1's count takes every entry's launches: all of them the inline one
    for k in ("sr_quant_keyed", "quant_matmul", "flash_attention", "flash_decode"):
        assert got[k] == 0, f"train mamba2 launched {k}: {got}"
    prof = profile_train_round(dev, sess, run["rounds"])
    emit({"train": {
        "run": "train", "arch": cfg.name, "card": f"{dev['kind']} ({dev['smi']})",
        "layers": cfg.n_layers, "d_model": cfg.d_model, "mesh": "4x1",
        "batch_per_client": 2, "seq": 512, "comm_bits": 4,
        "wire_codes": str(rows[-1]["k2_args"][-1]),
        "wire_leaf_elems": [leaf[0].numel() for leaf in wire], "setup_s": setup_s,
        "wall_s": wall, "losses": [h["loss"] for h in hist], "launches": got,
        "k1_uses_a_step": uses, "device_ms": prof["device_ms"],
        "comm_report": {k: v for k, v in sess.comm_report().items() if k != "rounds"},
        "rounds": [{k: v for k, v in r.items() if k != "k2_args"} for r in rows]}})
    del sess, rows, wire
    torch.cuda.empty_cache()
    return {k: got[k] for k in ("sr_quant", "sr_quant_inline", "sr_pack", "sr_pack_keyed")}


def train_seamless(dev: dict) -> dict:
    """The ``train`` run (8-bit weights, int8 wire) on seamless-m4t-large-v2
    at full width cut to 4 encoder + 4 decoder layers, 4x1 mesh, batch 2,
    sequence 256 (the frames zero, as the reference feeds them): finite
    losses, one inline K1 launch a weight use (the embed, the adapter and
    the unembed once; 7 an encoder layer and 11 a decoder layer, twice under
    remat; the norms exempt), one call of K2's keyed entry a step, the peak
    memory, and a profiled round.  Returns its K1 and K2 launches."""
    run = TRAIN_RUNS["train"]
    rows: list = []
    sess = _train_session(run, "cuda", arch="seamless-m4t-large-v2", layers=4, seq=256,
                          n_encoder_layers=4)
    cfg = sess.cfg
    t0 = time.time()
    sess._ensure_train_state()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    ops.reset_launches()
    t0 = time.time()
    with train_clock(rows):
        hist = sess.run_train()
    wall = time.time() - t0
    got = dict(ops.LAUNCHES)
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.remat) == (4, 4, 1024, True), \
        cfg
    uses = 4 * (3 + 2 * (7 * cfg.n_encoder_layers + 11 * cfg.n_layers))
    assert uses == 588, uses
    wire = rows[-1]["k2_args"][0]
    for h, r in zip(hist, rows):
        assert np.isfinite(h["loss"]), h
        assert r["k2_launches"] == r["k2_keyed_launches"] == 1, r
        assert r["k1_launches"] == r["k1_inline_launches"] == uses, (uses, r)
        print(f"train seamless round {h['round']}: loss {h['loss']:.4f} step "
              f"{r['step_s'] * 1e3:.1f} ms K1 launches {r['k1_launches']} K2 launches "
              f"{r['k2_launches']} peak {r['peak_mem_gb']:.2f} GB")
    for k in ("sr_quant_keyed", "quant_matmul", "flash_attention", "flash_decode"):
        assert got[k] == 0, f"train seamless launched {k}: {got}"
    prof = profile_train_round(dev, sess, run["rounds"])
    emit({"train": {
        "run": "train", "arch": cfg.name, "card": f"{dev['kind']} ({dev['smi']})",
        "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
        "d_model": cfg.d_model, "mesh": "4x1", "batch_per_client": 2, "seq": 256,
        "comm_bits": 4, "wire_codes": str(rows[-1]["k2_args"][-1]),
        "wire_leaf_elems": [leaf[0].numel() for leaf in wire], "setup_s": setup_s,
        "wall_s": wall, "losses": [h["loss"] for h in hist], "launches": got,
        "k1_uses_a_step": uses, "device_ms": prof["device_ms"],
        "comm_report": {k: v for k, v in sess.comm_report().items() if k != "rounds"},
        "rounds": [{k: v for k, v in r.items() if k != "k2_args"} for r in rows]}})
    del sess, rows, wire
    torch.cuda.empty_cache()
    return {k: got[k] for k in ("sr_quant", "sr_quant_inline", "sr_pack", "sr_pack_keyed")}


def phase_train_profile(dev: dict) -> None:
    """Round 0 of the ``train`` run (8-bit weights), then rounds 1 and 2
    profiled: host and device ms, busy share, host syncs, K1 launches.  It
    calls only what every tree of the port has, so ``--src=DIR`` runs it on
    a parent checkout in the same call."""
    sess = _train_session(TRAIN_RUNS["train"], "cuda")
    sess.fl_round(0)
    for r in (1, 2):
        profile_train_round(dev, sess, r)
    del sess
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- grids
#: The JAX package's committed sweep stores: read here, never written.
# ------------------------------------------------------------------ dist
#: phase dist's ranks: full-width yi-6b cut to 2 layers on a 4x1 mesh, 8-bit
#: weights, comm 8 (4 x 255 > 127: int16 codes, widened to int32 to be summed)
DIST_RANKS, DIST_LAYERS = 4, 2
DIST_RUNS = (
    dict(name="train", workload="train", rounds=1, precision=dict(weights=8, comm=8),
         options={"ckpt_every": 1}),
    dict(name="fl-orchestrate", workload="fl-orchestrate", rounds=1,
         precision=dict(comm=8), options={"scheme": "unified_q"}),
)
#: K1 inline launches a step and rank: embed and unembed once, the 7 block
#: weights of each layer twice (remat)
DIST_K1_PER_STEP = 2 + 7 * DIST_LAYERS * 2


def _split_pack(leaves, key: int, lim: int, dtype, scales, scaled):
    """The keyed wire as D ranks run it, row c as rank c: pass 1 a row, the
    max of the rows' scales, pass 2 a row at stream offset c.  Returns
    (codes (C, P), step of row 0, the rows' counts summed)."""
    C = len(leaves[0])
    rows = [[[leaf[c]] for leaf in leaves] for c in range(C)]
    firsts = [scales(r) for r in rows]
    smax = torch.stack([f[0][0] for f in firsts]).amax(dim=0)
    outs = [scaled(r, smax, f[0], key, lim, dtype, c) for c, (r, f) in enumerate(zip(rows,
                                                                                     firsts))]
    if not all(torch.equal(o[1], outs[0][1]) for o in outs):
        raise AssertionError("sr_pack_keyed split: the ranks' pitches differ")
    return (torch.cat([o[0] for o in outs]), outs[0][1],
            sum(f[1].to(torch.int64) for f in firsts))


def check_sr_pack_split(table: dict) -> None:
    """K2's split entries on the card: composed over the rows, bit-equal to
    the one-call keyed entry (codes, pitch, non-finite count) at the
    trainer's wire (4 x 69,632), at 4 x 4096 x 11008 and with NaN/Inf; each
    pass bit-equal to its plain version; each pass timed at one rank's row
    beside its bound and its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    key = 0x9E3779B97F4A7C15
    cases = [("train step wire", TRAIN_WIRE_SIZES, 8, torch.int16),
             ("4x4096x11008", [4096 * 11008], 8, torch.int16),
             ("ragged, int8", [5, 130, 1, 4099], 4, torch.int8)]
    for label, sizes, bits, dtype in cases:
        leaves = _grads(sizes, 4, gen, scale=0.05)
        lim = 2**bits - 1
        want = sq.sr_pack_keyed_cuda(leaves, key, lim, dtype)
        got = _split_pack(leaves, key, lim, dtype, sq.sr_pack_keyed_scales_cuda,
                          sq.sr_pack_keyed_scaled_cuda)
        _same_pack(f"split {label}", got, want)
        row = [[leaf[1]] for leaf in leaves]
        f_c, b_c = sq.sr_pack_keyed_scales_cuda(row)
        f_p, b_p = sq.sr_pack_keyed_scales_plain(row)
        smax = torch.stack([f_c[0], f_c[0] * 1.5]).amax(dim=0)
        q_c = sq.sr_pack_keyed_scaled_cuda(row, smax, f_c, key, lim, dtype, 1)
        q_p = sq.sr_pack_keyed_scaled_plain(row, smax, f_c, key, lim, dtype, 1)
        torch.cuda.synchronize()
        for name, a, b in (("pass 1 fmax", f_c, f_p), ("pass 1 count", b_c, b_p),
                           ("pass 2 codes", q_c[0], q_p[0]), ("pass 2 pitch", q_c[1], q_p[1])):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"sr_pack_keyed split {label}: {name} differs from the "
                                     "plain version")
        if label == "ragged, int8":
            continue
        P = sum(sizes)
        big = P > 1e7
        for name, fn, plain, args, cost in (
                ("sr_pack_keyed_scales", sq.sr_pack_keyed_scales_cuda,
                 sq.sr_pack_keyed_scales_plain, (row,), count.sr_pack_keyed_scales_cost(
                     P, 1, len(sizes))),
                ("sr_pack_keyed_scaled", sq.sr_pack_keyed_scaled_cuda,
                 sq.sr_pack_keyed_scaled_plain, (row, smax, f_c, key, lim, dtype, 1),
                 count.sr_pack_keyed_scaled_cost(P, 1, len(sizes), dtype))):
            b_ms, b_by = bound_ms(cost)
            kernel_ms = time_ms(fn, [args], iters=10 if big else 50)
            out = dict(kernel=name, case=f"{label}, one rank's row", rows=1, leaves=len(sizes),
                       P=P, bits=bits, codes=str(dtype), max_abs_err=0.0, kernel_ms=kernel_ms,
                       bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / kernel_ms,
                       plain_ms=time_events_ms(plain, args, iters=3, warmup=1),
                       library_ms=None)
            emit(out)
            if label == "train step wire":
                table[name] = out
        del leaves, want, got
    # NaN and +-Inf under "saturate": the guard's clamp is each row's own
    leaves = _grads([9, 14, 5], 4, gen, scale=1.0)
    leaves[0][0][1], leaves[1][2][3], leaves[1][0][0] = float("nan"), float("inf"), -float("inf")
    leaves[2][1][:] = float("inf")
    got = _split_pack(leaves, key, 255, torch.int16, sq.sr_pack_keyed_scales_cuda,
                      sq.sr_pack_keyed_scaled_cuda)
    _same_pack("split NaN/Inf", got, sq.sr_pack_keyed_cuda(leaves, key, 255, torch.int16))
    _same_pack("split NaN/Inf (plain)", got, _split_pack(
        _cpu(leaves), key, 255, torch.int16, sq.sr_pack_keyed_scales_plain,
        sq.sr_pack_keyed_scaled_plain))
    if int(got[2]) != 8:
        raise AssertionError(f"sr_pack_keyed split: non-finite count {int(got[2])}, want 8")
    print("sr_pack_keyed split: pass 1 a row, the rows' max, pass 2 at stream offset c equal "
          "the one-call entry bit for bit (trainer's wire, 4x4096x11008, ragged int8, NaN/Inf)"
          "; each pass equals its plain version")


def dist_worker(job_path: str) -> None:
    """One rank of phase dist (started by ``torch.distributed.run``): the
    job's runs through ``Session.run_train`` with each round's launches,
    collectives, host ms (the checkpoint's gather and write apart), span on
    the card's clock (CUDA events around the round) and peak memory; rank
    r's results to ``<out_dir>/rank<r>.json`` and a line on stdout."""
    from repro_torch.launch.mesh import init_distributed

    import torch.distributed as dist

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(job["backend"], None, share_device=job["share_device"])
    rank = dist.get_rank()
    if "serve" in job:
        serve_dist_rank(job, dev, rank)
        dist.destroy_process_group()
        return
    if any(phase in job for phase in TP_PHASES):
        out = {"rank": rank, "device": str(dev)}
        for phase in TP_PHASES:
            if phase in job:
                try:
                    part = train_tp_rank if phase == "train_tp" else serve_tp_rank
                    out[phase] = part(job[phase], dev, rank)
                except Exception as e:
                    raise RuntimeError(f"tp rank {rank}: phase {phase}'s part failed") from e
        with open(os.path.join(job["out_dir"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
        return
    out = {"rank": rank, "device": str(dev), "backend": job["backend"], "runs": []}
    from repro_torch.ckpt import checkpoint as ckpt

    gather_state, save = ckpt.gather_state, ckpt.save_checkpoint
    ckpt_ms = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ckpt_ms[0] += (time.perf_counter() - t0) * 1e3
        return run

    ckpt.gather_state, ckpt.save_checkpoint = timed(gather_state), timed(save)
    for run in job["runs"]:
        if "ckpt_every" in run["options"]:
            run = {**run, "options": {**run["options"],
                                      "ckpt_dir": os.path.join(job["out_dir"], run["name"])}}
        sess = _train_session(run, str(dev), layers=job["layers"], mesh=job["mesh"])
        t0 = time.time()
        sess._ensure_train_state()
        torch.cuda.synchronize(dev)
        setup_s = time.time() - t0
        transport = sess.axes.transport
        rows: list = []
        ops.reset_launches()
        with counted_rounds(rows, dev, {"batch": transport}, ckpt_ms):
            hist = sess.run_train()
        for row in rows:
            row["collectives"] = row["collectives"]["batch"]
        res = {"run": run["name"], "setup_s": setup_s, "launches": dict(ops.LAUNCHES),
               "losses": [h["loss"] for h in hist], "rounds": rows,
               "staged": dict(transport.staged),
               "comm_report": {k: v for k, v in sess.comm_report().items() if k != "rounds"}}
        out["runs"].append(res)
        print(f"dist rank {rank} {run['name']}: " + json.dumps(
            {"rounds": rows, "staged": res["staged"]}), flush=True)
        del sess
        torch.cuda.empty_cache()
    with open(os.path.join(job["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


#: the trainer's kernels a round's row counts
_TRAIN_KERNELS = ("sr_quant_inline", "sr_pack_keyed_scales", "sr_pack_keyed_scaled",
                  "sr_pack_keyed", "sr_pack")


@contextlib.contextmanager
def counted_rounds(rows: list, dev, groups: dict, ckpt_ms: list | None = None):
    """``Session.fl_round`` wrapped for the block: per round a row of its
    loss, host ms (``ckpt_ms[0]``, the checkpoint's share, apart), span on
    the card's clock (CUDA events around the round), peak memory, the
    trainer's kernel launches and each of ``groups``' collectives (``name
    -> Transport``, None for none) by kind, dtype, calls and bytes."""
    from repro_torch.api.session import Session

    fl_round = Session.fl_round

    def issued():
        return {n: {k: list(v) for k, v in t.issued.items()} for n, t in groups.items()
                if t is not None}

    def counted_round(self, r):
        before, launches = issued(), dict(ops.LAUNCHES)
        if ckpt_ms is not None:
            ckpt_ms[0] = 0.0
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        rec = fl_round(self, r)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ck = ckpt_ms[0] if ckpt_ms is not None else 0.0
        after = issued()
        rows.append({
            "round": r, "loss": rec["loss"], "host_ms": host_ms, "checkpoint_ms": ck,
            "step_ms": host_ms - ck, "span_ms": start.elapsed_time(end),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": {k: ops.LAUNCHES[k] - launches[k] for k in _TRAIN_KERNELS},
            "collectives": {n: {f"{k} {dt}": {"calls": c - before[n].get((k, dt), [0, 0])[0],
                                              "bytes": b - before[n].get((k, dt), [0, 0])[1]}
                                for (k, dt), (c, b) in after[n].items()
                                if c != before[n].get((k, dt), [0, 0])[0]}
                            for n in after}})
        return rec

    Session.fl_round = counted_round
    try:
        yield
    finally:
        Session.fl_round = fl_round


def _torchrun(n: int, job: dict, out_dir: str, timeout_s: float, env=None) -> list:
    """``job`` on ``n`` ranks (``torch.distributed.run --standalone``, this
    script in worker mode, ``env`` added to the environment); returns the
    ranks' results.  A failing rank fails the phase with each rank's last
    lines."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "job.json")
    with open(path, "w") as f:
        json.dump({**job, "out_dir": out_dir}, f)
    logs = os.path.join(out_dir, "logs")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", f"--log-dir={logs}", "--redirects=3", "--tee=3",
           os.path.abspath(__file__), f"--src={SRC}", f"--dist-worker={path}"]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                          env={**os.environ, "OMP_NUM_THREADS": "2", **(env or {})})
    with open(os.path.join(out_dir, "torchrun.log"), "w") as f:
        f.write(proc.stdout + "\n" + proc.stderr)
    if proc.returncode != 0:
        # each rank's own last lines (torchrun's log dir: <run>/attempt_0/<rank>/)
        tails = []
        for r in range(n):
            for path in sorted(glob.glob(os.path.join(logs, "*", "attempt_*", str(r),
                                                      "stderr.log"))):
                with open(path) as f:
                    tails.append(f"--- rank {r} stderr:\n{f.read()[-2500:]}")
        raise AssertionError(f"dist: {n} ranks failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n" + "\n".join(tails))
    for line in proc.stdout.splitlines():
        line = re.sub(r"^\[default\d+\]:", "", line)       # torchrun's --tee prefix
        if line.startswith(("dist rank", "tp rank")):
            print(line[:4000])
    for line in proc.stderr.splitlines():
        if "staged" in line or "widened" in line:
            print(line[:300])
    print(f"dist: {n} rank(s) over {job['backend']} ran in {time.time() - t0:.1f} s")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def phase_dist(dev: dict, table: dict) -> dict:
    """Phase dist (see the module docstring); returns the split K2 entries'
    launches in the 4-rank run, summed over the ranks."""
    import tempfile

    from repro_torch.ckpt.checkpoint import load_checkpoint
    from repro_torch.models.common import fsdp_plan

    check_sr_pack_split(table)
    base = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    ranks = _torchrun(DIST_RANKS, {"backend": "gloo", "share_device": True,
                                   "mesh": f"{DIST_RANKS}x1", "layers": DIST_LAYERS,
                                   "runs": list(DIST_RUNS)}, os.path.join(base, "gloo"), 600)
    launches = {"sr_pack_keyed_scales": 0, "sr_pack_keyed_scaled": 0}
    for rk in ranks:
        for res in rk["runs"]:
            assert all(np.isfinite(x) for x in res["losses"]), res["losses"]
            assert res["losses"] == ranks[0]["runs"][rk["runs"].index(res)]["losses"],                 "the ranks' pmean-ed losses differ"
            for row in res["rounds"]:
                want = {"sr_quant_inline": DIST_K1_PER_STEP, "sr_pack_keyed_scales": 1,
                        "sr_pack_keyed_scaled": 1, "sr_pack_keyed": 0, "sr_pack": 1}
                if row["launches"] != want:
                    raise AssertionError(f"dist rank {rk['rank']} {res['run']} round "
                                         f"{row['round']}: launches {row['launches']}, want "
                                         f"{want}")
            for k in launches:
                launches[k] += res["launches"][k]
    r0 = {res["run"]: res for res in ranks[0]["runs"]}
    emit({"dist": {"card": f"{dev['kind']} ({dev['smi']})", "ranks": DIST_RANKS,
                   "backend": "gloo", "share_device": True, "arch": "yi-6b",
                   "layers": DIST_LAYERS, "mesh": f"{DIST_RANKS}x1", "batch_per_client": 2,
                   "seq": 512, "comm_bits": 8, "wire": "int16 codes summed as int32",
                   "per_rank": [{"rank": rk["rank"], "runs": [
                       {k: res[k] for k in ("run", "setup_s", "losses", "rounds", "staged")}
                       for res in rk["runs"]]} for rk in ranks],
                   "comm_report": r0["train"]["comm_report"]}})
    # the same spec as one process (the loop), one round, from the same init
    # and keys: held to the 4 ranks' checkpoint after their first step
    run = {**DIST_RUNS[0], "rounds": 1, "options": {}}
    sess = _train_session(run, "cuda", layers=DIST_LAYERS)
    hist = sess.run_train()
    params = sess._train_state["params"]
    state, _manifest = load_checkpoint(os.path.join(base, "gloo", "train"),
                                       {"p": params, "o": sess._train_state["opt_state"]},
                                       step=1)
    paths, _leaves, plan = fsdp_plan(params, DIST_RANKS)
    worst_fsdp, n_wire = 0.0, 0
    for path, dim in zip(paths, plan):
        a, b = state["p"][path], params[path]
        if dim is None:
            n_wire += 1
            if not torch.equal(a, b):
                raise AssertionError(f"dist: wire leaf {path} differs from the loop's "
                                     f"({int((a != b).sum())} elements)")
        else:
            # rtol of the leaf's largest magnitude: four addends summed in
            # another order move an element near zero by an ulp of its update
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst_fsdp = max(worst_fsdp, rel)
            if rel > 1e-6:
                raise AssertionError(f"dist: FSDP leaf {path} differs from the loop's by "
                                     f"{rel:.3g} of its largest magnitude (limit 1e-6)")
    d_loss = abs(r0["train"]["losses"][0] - hist[0]["loss"])
    if d_loss > 1e-6:
        raise AssertionError(f"dist: loss {r0['train']['losses'][0]} vs the loop's "
                             f"{hist[0]['loss']}")
    print(f"dist: 4 ranks vs the loop after one step: {n_wire} wire leaves bit-equal, "
          f"{len(paths) - n_wire} FSDP leaves within rtol {worst_fsdp:.3g} (limit 1e-6), loss "
          f"{hist[0]['loss']:.6f} (|d| {d_loss:.3g})")
    del sess, params, state
    torch.cuda.empty_cache()
    # one rank over NCCL: the backend starts, trains a round and exits
    nccl = _torchrun(1, {"backend": "nccl", "share_device": False, "mesh": "1x1",
                         "layers": DIST_LAYERS,
                         "runs": [{**DIST_RUNS[0], "rounds": 1, "options": {}}]},
                     os.path.join(base, "nccl"), 300)
    res = nccl[0]["runs"][0]
    assert nccl[0]["backend"] == "nccl" and np.isfinite(res["losses"][0]), nccl
    print(f"dist: one rank over nccl trained a round, loss {res['losses'][0]:.4f}, "
          f"collectives {res['rounds'][0]['collectives']}")
    return launches


# ------------------------------------------------------------ serve_dist
#: phase serve_dist: phase serve's yi-6b configuration (lazy int8, paged f32
#: KV in 16-token pages, flash, batch 4, 8 requests of 64-128 tokens) on a
#: 4x1 mesh: 4 data shards of one slot
SERVE_DIST_SHARDS = 4
#: the one-process 4x1 loop's depth: 8 of yi-6b's 32 layers, cut for the
#: script's time limit once phase train_tp joined (its NCCL rank runs at
#: ``DIST_LAYERS``, as the gloo ranks do)
SERVE_DIST_LOOP_LAYERS = 8
#: the tokens a request of phase serve_dist's ranks and their loop decode
#: (cut from 16 for the time limit)
SERVE_DIST_RANKS_MAX_NEW = 8
SERVE_DIST_OPTIONS = {**SERVE_RUNS["yi-6b"]["options"], "attn_impl": "flash",
                      "kv_layout": "paged", "page_size": 16, "vary_prompt": True,
                      "quiet": True}


def _serve_dist_session(device: str, mesh: str, layers: int | None = None, *,
                        arch: str = "yi-6b", base_options=None, smoke: bool = False,
                        cut: dict | None = None, **options):
    """Full-width ``arch`` (its smoke size with ``smoke``) served at
    ``base_options`` (default: phase serve_dist's) updated by ``options`` on
    ``mesh`` (depth cut to ``layers``; ``cut``: other config fields
    replaced), its model's prefills and decode steps counted (a shard's call
    is one) and each decode call's host clock kept."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.models.model import count_passes

    spec = RunSpec(arch, workload="serve", mesh=mesh, smoke=smoke, seed=0, batch=4,
                   seq=256, precision=PrecisionPolicy.lazy_int8(7),
                   options={**(SERVE_DIST_OPTIONS if base_options is None else base_options),
                            **options})
    sess = Session(spec, device=device)
    cut = {**(cut or {}), **({} if layers is None else {"n_layers": layers})}
    if cut:
        sess.cfg = dataclasses.replace(sess.cfg, **cut)
    passes, ticks = {"prefill": 0, "decode": 0}, []
    sess.model = count_passes(sess.model, passes, ticks)
    return sess, passes, ticks


def _host_ms_a_step(ticks: list, calls_a_step: int) -> float:
    """The median host ms between one decode step's start and the next's
    (``calls_a_step`` shard calls a step)."""
    starts = ticks[::calls_a_step]
    return float(np.median(np.diff(starts)) * 1e3) if len(starts) > 1 else float("nan")


def _serve_dist_run(sess, passes, ticks, device) -> dict:
    """``sess.serve()`` with the launch counters zeroed just before and read
    just after: its stats, tokens, launches, passes and memory."""
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    t0 = time.time()
    stats = sess.serve()
    wall = time.time() - t0
    launches = {k: ops.LAUNCHES[k] for k in _ATTN_KERNELS}
    calls = max(sess.axes.dp, 1) if sess.axes.transport is None else 1
    return {"stats": {k: v for k, v in vars(stats).items() if k not in ("wall_s", "tok_s")},
            "tok_s": stats.tok_s, "serve_wall_s": wall, "tokens": list(sess.last_tokens),
            "launches": launches, "passes": dict(passes),
            "host_ms_a_step": _host_ms_a_step(ticks, calls),
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}


def serve_dist_rank(job: dict, dev, rank: int) -> None:
    """One rank of phase serve_dist (started by ``torch.distributed.run``):
    its shard of the serve, the collectives it issued by kind, calls and
    bytes, and those staged through the host; to ``<out_dir>/rank<r>.json``
    and a line on stdout."""
    run = job["serve"]
    sess, passes, ticks = _serve_dist_session(str(dev), run["mesh"], run.get("layers"),
                                              **run["options"])
    res = _serve_dist_run(sess, passes, ticks, dev)
    report = sess.axes.transport.report()
    res.update(rank=rank, device=str(dev), backend=job["backend"], issued=report["issued"],
               staged=report["staged"])
    with open(os.path.join(job["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print(f"dist rank {rank} serve: " + json.dumps(
        {k: res[k] for k in ("tok_s", "host_ms_a_step", "peak_gb", "passes", "launches",
                             "issued", "staged")}), flush=True)


def _gathers_a_pass(cfg, fsdp: int) -> tuple[int, int]:
    """``(calls, bytes)`` of one pass's FSDP gathers on a rank: one uint8
    all-gather a use of each FSDP leaf (a stacked leaf once a layer) of its
    whole int8 codes."""
    from repro_torch.models.common import fsdp_plan, is_stacked
    from repro_torch.models.model import build_model

    meta = build_model(cfg).init(torch.Generator().manual_seed(0), 1, device="meta")
    paths, leaves, plan = fsdp_plan(meta, fsdp)
    calls = nbytes = 0
    for path, w, dim in zip(paths, leaves, plan):
        if dim is not None:
            calls += w.shape[0] if is_stacked(path) else 1
            nbytes += w.numel()
    return calls, nbytes


def _same_serve(label: str, got: dict, want: dict) -> None:
    """A rank's stats (clocks apart) and tokens against a one-process run's."""
    if got["stats"] != json.loads(json.dumps(want["stats"])):
        diff = {k: (v, want["stats"].get(k)) for k, v in got["stats"].items()
                if v != json.loads(json.dumps(want["stats"])).get(k)}
        raise AssertionError(f"serve_dist: {label}'s ServeStats differ: {diff}")
    if got["tokens"] != want["tokens"]:
        n = next(i for i, (a, b) in enumerate(zip(got["tokens"], want["tokens"])) if a != b) \
            if len(got["tokens"]) == len(want["tokens"]) else "length"
        raise AssertionError(f"serve_dist: {label}'s tokens differ (first at {n})")


def phase_serve_dist(dev: dict) -> dict:
    """Batch-sharded serving (see the module docstring); returns the
    one-process 4x1 run's K3/K4/K5 launches."""
    import tempfile

    card = f"{dev['kind']} ({dev['smi']})"
    D = SERVE_DIST_SHARDS
    # (1) one process, 4x1, full width, depth cut: the main path of the phase
    sess, passes, ticks = _serve_dist_session("cuda", f"{D}x1", SERVE_DIST_LOOP_LAYERS)
    loop = _serve_dist_run(sess, passes, ticks, "cuda")
    cfg, st = sess.cfg, loop["stats"]
    assert (cfg.n_layers, cfg.d_model) == (SERVE_DIST_LOOP_LAYERS, 4096), cfg
    n_req = SERVE_DIST_OPTIONS["requests"]
    assert st["admitted"] == st["completed"] == n_req, st
    assert passes["decode"] == D * st["decode_steps"], (passes, st)
    pre, dec = (expected_launches(cfg, kind, 0) for kind in ("prefill", "decode"))
    want = {k: passes["prefill"] * pre[k] + passes["decode"] * dec[k] for k in pre}
    if loop["launches"] != want or not all(want.values()):
        raise AssertionError(f"serve_dist 4x1: launches {loop['launches']}, want {want} "
                             f"({passes})")
    assert all(0 <= t < cfg.vocab_size for t in loop["tokens"]), "sampled id out of range"
    emit({"serve_dist": {"run": f"one process {D}x1", "card": card, "arch": cfg.name,
                         "layers": cfg.n_layers, "tok_s": loop["tok_s"],
                         "admitted": st["admitted"], "completed": st["completed"],
                         "decode_steps": st["decode_steps"], "passes": passes,
                         "launches": loop["launches"],
                         "a_shard_and_pass": {"prefill": pre, "decode": dec},
                         "host_ms_a_step": loop["host_ms_a_step"],
                         "serve_wall_s": loop["serve_wall_s"], "peak_gb": loop["peak_gb"],
                         "kv_bytes": st["kv_bytes"], "sample": st["sample"]}})
    del sess
    torch.cuda.empty_cache()
    # (2) the loop at 2 layers: what the ranks must equal
    small = dict(layers=DIST_LAYERS, max_new=SERVE_DIST_RANKS_MAX_NEW)
    sess2, passes2, ticks2 = _serve_dist_session("cuda", f"{D}x1", DIST_LAYERS,
                                                 max_new=SERVE_DIST_RANKS_MAX_NEW)
    loop2 = _serve_dist_run(sess2, passes2, ticks2, "cuda")
    cfg2 = sess2.cfg
    del sess2
    torch.cuda.empty_cache()
    # (3) D gloo ranks sharing the card, one shard each
    base = tempfile.mkdtemp(prefix="chip_smoke_serve_dist_")
    ranks = _torchrun(D, {"backend": "gloo", "share_device": True,
                          "serve": {"mesh": f"{D}x1", "layers": DIST_LAYERS,
                                    "options": {"max_new": SERVE_DIST_RANKS_MAX_NEW}}},
                      os.path.join(base, "gloo"), 600)
    g_calls, g_bytes = _gathers_a_pass(cfg2, D)
    pre2, dec2 = (expected_launches(cfg2, kind, 0) for kind in ("prefill", "decode"))
    per_rank = []
    for rk in ranks:
        _same_serve(f"gloo rank {rk['rank']}", rk, loop2)
        n = rk["passes"]["prefill"] + rk["passes"]["decode"]
        want = {k: rk["passes"]["prefill"] * pre2[k] + rk["passes"]["decode"] * dec2[k]
                for k in pre2}
        if rk["launches"] != want:
            raise AssertionError(f"serve_dist rank {rk['rank']}: launches {rk['launches']}, "
                                 f"want {want}")
        issued = rk["issued"]
        gathered = issued.get("all-gather uint8", {})
        tokens = issued.get("all-gather int32", {})
        if (gathered.get("calls"), gathered.get("bytes")) != (n * g_calls, n * g_bytes) or \
                (tokens.get("calls"), tokens.get("bytes")) != (n, n * 4 * 4):
            raise AssertionError(f"serve_dist rank {rk['rank']}: collectives {issued}, want "
                                 f"{g_calls} gathers of {g_bytes} bytes and one token "
                                 f"gather a pass over {n} passes")
        per_rank.append({"rank": rk["rank"], "tok_s": rk["tok_s"],
                         "host_ms_a_step": rk["host_ms_a_step"], "peak_gb": rk["peak_gb"],
                         "passes": rk["passes"], "launches": rk["launches"],
                         "a_pass": {k: {"calls": v["calls"] / n, "bytes": v["bytes"] / n}
                                    for k, v in issued.items() if not k.startswith("broadcast")},
                         "issued": issued, "staged": rk["staged"]})
    emit({"serve_dist": {"run": f"{D} gloo ranks sharing the card", "card": card,
                         "arch": cfg2.name, "layers": cfg2.n_layers, **small,
                         "loop": {k: loop2[k] for k in ("tok_s", "host_ms_a_step", "peak_gb",
                                                         "passes", "launches")},
                         "gathers_a_pass_predicted": {"calls": g_calls, "bytes": g_bytes},
                         "per_rank": per_rank}})
    print(f"serve_dist: {D} gloo ranks' tokens ({len(loop2['tokens'])}) and ServeStats equal "
          f"the one-process {D}x1 loop's at {DIST_LAYERS} layers bit for bit")
    # (4) one NCCL rank at 1x1, 2 layers, against the plain 1x1 serve
    sess1, passes1, ticks1 = _serve_dist_session("cuda", "1x1", DIST_LAYERS,
                                                 max_new=SERVE_DIST_RANKS_MAX_NEW)
    plain = _serve_dist_run(sess1, passes1, ticks1, "cuda")
    layers1 = sess1.cfg.n_layers
    del sess1
    torch.cuda.empty_cache()
    nccl = _torchrun(1, {"backend": "nccl", "share_device": False,
                         "serve": {"mesh": "1x1", "layers": DIST_LAYERS,
                                   "options": {"max_new": SERVE_DIST_RANKS_MAX_NEW}}},
                     os.path.join(base, "nccl"), 600)[0]
    _same_serve("the nccl rank", nccl, plain)
    assert nccl["backend"] == "nccl" and nccl["launches"] == plain["launches"], nccl
    emit({"serve_dist": {"run": "one nccl rank at 1x1", "card": card, "layers": layers1,
                         "max_new": SERVE_DIST_RANKS_MAX_NEW, "tok_s": nccl["tok_s"],
                         "plain_tok_s": plain["tok_s"],
                         "host_ms_a_step": nccl["host_ms_a_step"],
                         "plain_host_ms_a_step": plain["host_ms_a_step"],
                         "peak_gb": nccl["peak_gb"], "issued": nccl["issued"]}})
    print("serve_dist: the nccl rank's tokens and ServeStats equal the plain 1x1 serve's")
    return loop["launches"]


# --------------------------------------------------------------- serve_tp
#: phase serve_tp: 4 gloo ranks sharing the card, one model shard each
#: (NCCL refuses two ranks on one GPU).  yi-6b at phase serve's
#: configuration (KV heads split: the paged cache, K5), max_new cut from 32
#: to 16, depth cut to ``SERVE_TP_YI_LAYERS`` for the time limit once phase
#: train_tp joined the ranks; glm4-9b at full width (2 KV heads over 4 shards: the
#: sequence-parallel cache, which the driver serves contiguous), depth cut to
#: ``SERVE_TP_GLM_LAYERS``, max_new 16; then the step-level runs
#: (``SERVE_TP_STEPS``), each held against the 1x1 model, glm4-9b's paged
#: through per-shard page tables, K5 on each rank's pool and the partials
#: merged across the ranks.  ``cut``: the config fields a run replaces.
SERVE_TP_RANKS = 4
SERVE_TP_OPTIONS = {**SERVE_RUNS["yi-6b"]["options"], "max_new": 16, "attn_impl": "flash",
                    "quiet": True}
SERVE_TP_RUNS = (dict(arch="yi-6b", cut=dict(n_layers=SERVE_TP_YI_LAYERS),
                      options={**SERVE_TP_OPTIONS, "kv_layout": "paged", "page_size": 16}),
                 dict(arch="glm4-9b", cut=dict(n_layers=SERVE_TP_GLM_LAYERS),
                      options=SERVE_TP_OPTIONS))
#: phase serve_tp's step-level runs, 4 layers at full width in f32: yi-6b
#: (KV heads split) on the contiguous cache; glm4-9b (sequence-parallel) on
#: the contiguous cache, then on the paged one through per-shard tables.
#: Slot 0's 20 tokens stay in shard 0's 64 positions (the other shards' K5
#: sees local length 0), slot 1's 62 cross into shard 1's at the third step.
SERVE_TP_STEPS = tuple(dict(arch=arch, cut=dict(n_layers=4), plens=(20, 62, 100, 200), steps=4,
                            layout="contiguous", seq_paged=paged)
                       for arch, paged in (("yi-6b", False), ("glm4-9b", True)))
#: the step-level flash logits against the contiguous ones: K5's f32 online
#: softmax and merge add in another order than the plain merge, a few ulps of
#: each attention output, carried through the layers
SERVE_TP_PAGED_RTOL = 1e-4
#: each step-level run's logits (prefill and decode steps, through K3, K4
#: and K5 on 4 model shards) against the same seed's 1x1 model through the
#: plain versions, as ``torch.testing.assert_close`` with rtol = atol: phase
#: consistency's f32 tolerance of kernels against plain versions
SERVE_TP_1X1_TOL = 2e-3
#: the tensor-parallel phases' slots and positions (``_serve_dist_session``'s
#: batch and seq; an enc-dec's frames)
SERVE_TP_SLOTS, SERVE_TP_S_MAX = 4, 256

# ----------------------------------------------------- serve_tp_families
#: phase serve_tp_families: tensor-parallel serving of the SSM, hybrid, VLM
#: and enc-dec families on the same 4 ranks, lazy int8 weights, 4 slots,
#: s_max 256, 4 requests of fixed-length prompts (one prefill bucket),
#: flash.  mamba2-780m at full width, depth cut to 8 of 48 for the time
#: limit (each prompt token of its prefill is a pass of collectives),
#: 16-token prompts, contiguous (its O(1) state); seamless-m4t at full width
#: cut to 4 + 4 of 24 + 24 layers, paged (its 16 KV heads split 4 a shard;
#: the cross K/V split with them), frames over s_max; llama-3.2-vision at
#: full width at phase serve's 2 periods (10 layers), 64-token prompts,
#: paged (8 KV heads, 2 a shard); jamba at its smoke size (at full width it
#: does not fit one card), paged (4 KV heads, one a shard; 4 experts, one a
#: shard).
SERVE_TP_FAMILY_OPTIONS = {"attn_impl": "flash", "requests": 4, "quiet": True}
SERVE_TP_FAMILY_RUNS = (
    dict(arch="mamba2-780m", cut=dict(n_layers=8),
         options={**SERVE_TP_FAMILY_OPTIONS, "prompt_len": 16, "max_new": 8, "steps": 16}),
    dict(arch="seamless-m4t-large-v2", cut=dict(n_layers=4, n_encoder_layers=4),
         options={**SERVE_TP_FAMILY_OPTIONS, "prompt_len": 64, "max_new": 16, "steps": 24,
                  "kv_layout": "paged", "page_size": 16}),
    dict(arch="llama-3.2-vision-90b", cut=dict(n_layers=10),
         options={**SERVE_TP_FAMILY_OPTIONS, "prompt_len": 64, "max_new": 8, "steps": 16,
                  "kv_layout": "paged", "page_size": 16}),
    dict(arch="jamba-1.5-large-398b", smoke=True, cut={},
         options={**SERVE_TP_FAMILY_OPTIONS, "prompt_len": 16, "max_new": 8, "steps": 16,
                  "kv_layout": "paged", "page_size": 16}))
#: the step-level runs at full width in f32, 4 slots, s_max 256, each
#: against the same seed's 1x1 model through the plain versions (for
#: attention 1xT is the 1x1 model cut; the SSM's gated norm under tp is
#: taken over the shard's channels, the reference's semantics, so mamba2's
#: 1x1 model takes it in 4 groups): seamless-m4t at 2 + 2 layers (frames over
#: s_max) and llama-3.2-vision at one period (a cross and 4 self layers,
#: prompts of 20-64 tokens, cross gates 0.5), paged; mamba2 at 2 layers
#: (prompts of 3-8 tokens), contiguous.
SERVE_TP_FAMILY_STEPS = (
    dict(arch="seamless-m4t-large-v2", cut=dict(n_layers=2, n_encoder_layers=2),
         plens=(64, 64, 64, 64), steps=4, layout="paged"),
    dict(arch="llama-3.2-vision-90b", cut=dict(n_layers=5), plens=(20, 62, 64, 33), steps=4,
         layout="paged"),
    dict(arch="mamba2-780m", cut=dict(n_layers=2), plens=(3, 8, 5, 8), steps=4,
         layout="contiguous"))
# ------------------------------------------------------------- train_tp
#: phase train_tp: the trainer under tensor parallelism on the same 4 gloo
#: ranks, one mesh device each: full-width yi-6b (d 4096, 32 heads, 4 KV
#: heads, d_ff 11008, vocab 64,000) cut to 2 of 32 layers, batch 2 a client,
#: sequence 512, 8-bit weights, sequence parallelism and remat on (its
#: config), ``train`` rounds of one step each on 1x4 (one client) and on 2x2
#: (two clients, comm 8: K2's int16 codes, summed as int32).
TRAIN_TP_LAYERS, TRAIN_TP_ROUNDS, TRAIN_TP_SEQ, TRAIN_TP_BATCH = 2, 3, 512, 2
TRAIN_TP_RUNS = (dict(mesh="1x4", comm=8), dict(mesh="2x2", comm=8))
#: the step level: full width cut to 2 layers, f32 compute, 32-bit weights,
#: one sgd step of one client on 1x4 from the rank's slice of the one init,
#: the slices joined, against the same seed's 1x1 step through the plain
#: versions (mamba2's gated norm in 4 groups)
TRAIN_TP_STEPS = (dict(arch="yi-6b", cut=dict(n_layers=2)),
                  dict(arch="mamba2-780m", cut=dict(n_layers=2)))
#: a leaf's joined update against the 1x1 step's: within this share of the
#: 1x1 update's largest magnitude (f32 sums in other orders: the sequence's
#: blocks and the model ranks' parts)
TRAIN_TP_1X1_TOL = 1e-3

#: the tensor-parallel phases' parts: serves and step-level runs, and the
#: trainer's rounds and step levels.  The parts of the phases named run in
#: one torchrun (:func:`_tp_torchrun`), so the ranks start and warm up once.
TP_PHASES = {"serve_tp": {"runs": SERVE_TP_RUNS, "steps": SERVE_TP_STEPS},
             "serve_tp_families": {"runs": SERVE_TP_FAMILY_RUNS, "steps": SERVE_TP_FAMILY_STEPS},
             "train_tp": {"runs": TRAIN_TP_RUNS, "steps": TRAIN_TP_STEPS}}


def tp_collectives(cfg, T: int, passes: dict, bucket: int, B: int, s_src: int = 0) -> dict:
    """A model rank's collectives over a serve's passes (every prompt in one
    ``bucket``, ``B`` slots a pass), by kind and dtype: sums of the
    row-parallel outputs (compute dtype, ``(B, S, d)``), the greedy pick's
    max (f32) and min (int32) of its slots a pass that samples, and the
    closing check's one broadcast.  A pass sums

    * dense, MoE and VLM: the embedding and two a layer (attention and
      feed-forward; a VLM's cross layer its attention and gated MLP), a
      prefill one pass over the bucket (a VLM's adapter and cross K/V need
      none);
    * SSM: the embedding and each layer's ``wo``; hybrid: the embedding and
      each sublayer's mixer (attention or SSM) and feed-forward (MLP or
      MoE); their prefill one pass a token of the bucket (a loop of decode
      steps), the pick once at its end;
    * enc-dec: a prefill two an encoder layer over the ``s_src`` frames and
      no pick (decoding starts from BOS); a decode step the embedding and
      three a decoder layer (self, cross, MLP).

    A dense or MoE model's sequence-parallel decode layer adds q's
    all-gather to all heads and the merge's max of m (f32), sums of l (f32)
    and acc (compute dtype, ``(B, H, 1, hd)``)."""
    from repro_torch.models.attention import kv_cache_seq_parallel
    from repro_torch.models.transformer import attn_dims

    cd = "bfloat16" if cfg.compute_dtype == "bfloat16" else "float32"
    e = 2 if cd == "bfloat16" else 4
    L, d = cfg.n_layers, cfg.d_model
    P, Dc = passes["prefill"], passes["decode"]
    picks = P + Dc
    if cfg.family in ("ssm", "hybrid"):
        per = 1 + (L if cfg.family == "ssm" else 2 * L)
        tokens = P * bucket + Dc
        sums = [tokens * per, tokens * per * B * d * e]
    elif cfg.family == "encdec":
        enc, dec = 2 * cfg.n_encoder_layers, 1 + 3 * L
        sums = [P * enc + Dc * dec, (P * enc * s_src + Dc * dec) * B * d * e]
        picks = Dc
    else:
        per = 1 + 2 * L
        sums = [(P + Dc) * per, per * B * d * e * (P * bucket + Dc)]
    out = {f"all-reduce sum {cd}": sums, "all-reduce max float32": [picks, 4 * B * picks],
           "all-reduce min int32": [picks, 4 * B * picks], "broadcast object": [1, 0]}
    if cfg.family in ("dense", "moe") and kv_cache_seq_parallel(attn_dims(cfg, T)):
        ad = attn_dims(cfg, T)
        H, hd = ad.n_heads, ad.head_dim
        out[f"all-reduce sum {cd}"][0] += Dc * L
        out[f"all-reduce sum {cd}"][1] += Dc * L * B * H * hd * e
        f32 = out.setdefault("all-reduce sum float32", [0, 0])
        f32[0] += Dc * L
        f32[1] += Dc * L * B * H * 4
        out["all-reduce max float32"][0] += Dc * L
        out["all-reduce max float32"][1] += Dc * L * B * H * 4
        out[f"all-gather {cd}"] = [Dc * L, Dc * L * B * H * hd * e]
    return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(out.items())}


def _held_shapes() -> dict:
    """The launch shapes phase kernels holds against the plain versions, as
    :func:`k3_and_experts` names them: K3 ``(M, K, N, x dtype)``, K4 ``(BH,
    S, D, dtype)`` (both masks), K5 ``(B, KV, G, hd, page, n_pmax, q dtype,
    pool dtype)``."""
    k3 = {(M, K, N, str(dt)[6:]) for _a, _p, M, K, N, dts, _n in K3_MODEL_SHAPES for dt in dts}
    k4 = {(BH, S, D, str(dt)[6:]) for BH, D, S, dts in ATTN_CASES for dt in dts}
    k5 = set()
    for _label, shape, (qd, pd), _n in DECODE_CASES:
        kw = {"KV": 4, "G": 8, "hd": 128, "page": 16, "n_pmax": 16,
              "lengths": (253, 60, 100, 0), **shape}
        k5.add((len(kw["lengths"]), kw["KV"], kw["G"], kw["hd"], kw["page"], kw["n_pmax"],
                str(qd)[6:], str(pd)[6:]))
    return {"quant_matmul": k3, "flash_attention": k4, "flash_decode": k5}


#: the launch-shape counts of a :func:`k3_and_experts` record
_SHAPE_KEYS = ("k3_shapes", "k4_shapes", "k5_shapes")


def _unheld(record: dict) -> dict:
    """The launch shapes of ``record`` (:func:`k3_and_experts`) phase
    kernels does not hold."""
    held = _held_shapes()
    out = {}
    for name, key in zip(("quant_matmul", "flash_attention", "flash_decode"), _SHAPE_KEYS):
        keys = {tuple(int(x) if x.isdigit() else x for x in k.replace("x", " ").split())
                for k in record.get(key, {})}
        miss = sorted(" ".join(map(str, k)) for k in keys - held[name])
        if miss:
            out[name] = miss
    return out


def grouped_gated_norm(groups: int):
    """The SSM's gated norm with its variance over ``groups`` contiguous
    blocks of channels: what ``groups`` model shards compute, each over its
    own ``d_inner / groups`` channels (the reference's semantics under tp),
    for the 1x1 model that ``1 x groups`` is held to."""
    def norm(pc, path, scale, y, z, eps=1e-6):
        yf = y.to(torch.float32) * torch.nn.functional.silu(z.to(torch.float32))
        g = yf.reshape(*yf.shape[:-1], groups, yf.shape[-1] // groups)
        yn = (g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)).reshape(yf.shape)
        return (yn * (1.0 + pc.use_small(path, scale))).to(y.dtype)
    return norm


@contextlib.contextmanager
def _ssm_norm_in_groups(groups: int):
    """The SSM mixer's gated norm replaced by :func:`grouped_gated_norm`."""
    from repro_torch.models import ssm

    norm = ssm._gated_norm
    ssm._gated_norm = grouped_gated_norm(groups)
    try:
        yield
    finally:
        ssm._gated_norm = norm


def _tp_steps(dev, arch: str, cut: dict, plens, steps: int, layout: str,
              seq_paged: bool = False) -> dict:
    """A step-level run of ``arch`` (``cut``, f32 compute, int8 weights, the
    rank's slice of the one init, a VLM's cross gates 0.5) on this rank's
    model shard: a flash prefill of ``len(plens)`` slots (prompts of
    ``plens`` tokens where the family takes tokens; the stub frontend's
    images or frames drawn normal), then ``steps`` flash decode steps fed
    tokens 2, 3, ... on the ``layout`` cache (``"paged"``: 16-token pages,
    slot b's pages ``[b*n_pmax, (b+1)*n_pmax)``; a sequence-parallel
    contiguous cache decodes through the plain merge); K3, K4 and K5 counted
    and their shapes recorded; each pass's logits gathered over the model
    axis.  Rank 0 then runs the same seed's whole ``1x1`` model through the
    plain versions on the same inputs, its SSM's gated norm in T groups of
    channels (the other ranks wait at the next collective).  ``seq_paged``
    (the sequence-parallel glm4-9b): twice more on the paged cache through
    per-shard tables (the reference's tp=4 test's: slot b's local pages
    ``[b*n_loc, (b+1)*n_loc)`` of every shard's pool), once through the
    gathered view and once through K5 on the rank's pool with the partials
    merged across the ranks."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import default_exempt
    from repro_torch.dist.collectives import AxisCtx
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.paging import set_page_tables
    from repro_torch.launch.steps import build_init_fn, init_global_caches
    from repro_torch.models.common import ParamCtx, pack_params_for_policy
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config(arch), **cut, compute_dtype="float32")
    model = build_model(cfg)
    tp_axes = axis_ctx_for(f"1x{SERVE_TP_RANKS}", group="default")
    T, B = tp_axes.tp, len(plens)
    s_max, page = SERVE_TP_S_MAX, 16
    policy = PrecisionPolicy.lazy_int8(7)
    gen = torch.Generator(device=dev).manual_seed(5)
    spec = model.prefill_batch_spec(B, max(plens), s_max)
    batch = {name: torch.randn(tuple(t.shape), generator=gen, device=dev)
             for name, t in spec.items() if name != "tokens"}
    if "tokens" in spec:
        batch["tokens"] = torch.randint(2, cfg.vocab_size, (B, max(plens)), generator=gen,
                                        device=dev, dtype=torch.int32)
    lens = torch.tensor(plens, dtype=torch.int32, device=dev)
    k5_lengths: list = []
    decode = ops.flash_paged_decode

    def recording(q, kp, vp, pt, lloc):
        k5_lengths.append(lloc.tolist())
        return decode(q, kp, vp, pt, lloc)

    def pack(leaves):
        for name in ("periods/cross/gate", "periods/cross/mlp_gate"):
            if name in leaves:
                leaves[name] = torch.full_like(leaves[name], 0.5)
        return pack_params_for_policy(leaves, policy, exempt=default_exempt)

    def init(axes):
        return build_init_fn(model, axes, device=dev, pack=pack)(
            torch.Generator(device=dev).manual_seed(0))

    def run(axes, params, layout, impl, record):
        """``layout``: "contiguous", "paged" (a slot's pages on every shard's
        pool) or "per_shard" (the sequence-parallel tables)."""
        pc = ParamCtx.from_policy(axes, policy, compute_dtype=torch.float32)
        kw = {} if layout == "contiguous" else {"page_size": page}
        caches = init_global_caches(model, axes, s_max=s_max, batch_global=B, device=dev, **kw)
        if kw:
            shards = T if layout == "per_shard" else 1
            n = s_max // shards // page
            table = np.tile(np.arange(B * n, dtype=np.int32).reshape(B, n), (1, shards))
            caches = set_page_tables(caches, table, **(
                {"model_shard": axes.tp_index(), "tp": T} if shards > 1 else {}))
        ops.reset_launches()
        with torch.no_grad(), k3_and_experts(record):
            lg, caches = model.prefill(pc, params, batch, caches, attn_impl="flash",
                                       prompt_lens=lens)
            outs = [] if lg is None else [axes.all_gather_model(lg, axis=2)]
            for step in range(steps):
                tok = torch.full((B, 1), 2 + step, dtype=torch.int32, device=dev)
                lg, caches = model.decode_step(pc, params, {"token": tok}, caches,
                                               attn_impl=impl)
                outs.append(axes.all_gather_model(lg, axis=2))
        return torch.stack(outs)[..., :cfg.vocab_size], {k: ops.LAUNCHES[k]
                                                         for k in _ATTN_KERNELS}

    params = init(tp_axes)
    shapes: dict = {}
    got, launches = run(tp_axes, params, layout, "flash", shapes)
    big = float(got.abs().max())
    out = {"arch": arch, "cut": cut, "plens": list(plens), "steps": steps, "layout": layout,
           "rank": tp_axes.tp_index(), "launches": launches, "shapes": shapes,
           "logit_max_abs": big, "finite": bool(torch.isfinite(got).all())}
    if seq_paged:
        paged_ref, _ = run(tp_axes, params, "per_shard", "ref", {})
        ops.flash_paged_decode = recording
        try:
            paged_flash, out["paged_launches"] = run(tp_axes, params, "per_shard", "flash",
                                                     shapes)
        finally:
            ops.flash_paged_decode = decode
        dec = slice(1, None)          # the decode steps (the prefill is the same call)
        out.update(ref_bit_equal=bool(torch.equal(paged_ref[dec], got[dec])),
                   flash_max_abs=float((paged_flash[dec] - got[dec]).abs().max()),
                   k5_local_lengths=k5_lengths[::cfg.n_layers],
                   finite=out["finite"] and bool(torch.isfinite(paged_flash).all()))
    out["model"] = tp_axes.model_transport.report()
    del params
    if tp_axes.tp_index() == 0:
        one = AxisCtx()
        with plain_kernels(), _ssm_norm_in_groups(T):
            want, _ = run(one, init(one), layout, "flash", {})
        diff = (got - want).abs()
        out["vs_1x1"] = {"max_abs": float(diff.max()), "tol": SERVE_TP_1X1_TOL,
                         "ok": bool((diff <= SERVE_TP_1X1_TOL * (1 + want.abs())).all()),
                         "greedy_agreement": float((got.argmax(-1) == want.argmax(-1))
                                                   .float().mean())}
        del want
    del got
    torch.cuda.empty_cache()
    return out


def serve_tp_rank(job: dict, dev, rank: int) -> dict:
    """One rank's part of a tensor-parallel phase (started by
    ``torch.distributed.run``, :func:`_tp_torchrun`): each serve run on
    ``1x4`` with the launch counters zeroed just before and read just after,
    the launches by shape, its model group's collectives by kind, calls and
    bytes and those staged; then the step-level runs (:func:`_tp_steps`); a
    line on stdout each, and the part's seconds."""
    t0 = time.time()
    out = {"runs": [], "steps": []}
    for run in job["runs"]:
        sess, passes, ticks = _serve_dist_session(str(dev), f"1x{SERVE_TP_RANKS}",
                                                  arch=run["arch"], base_options=run["options"],
                                                  smoke=run.get("smoke", False), cut=run["cut"])
        shapes: dict = {}
        with k3_and_experts(shapes):
            res = _serve_dist_run(sess, passes, ticks, dev)
        res.update(arch=run["arch"], layers=sess.cfg.n_layers, shapes=shapes,
                   at=[sess.axes.dp_index(), sess.axes.tp_index()],
                   model=sess.axes.model_transport.report())
        out["runs"].append(res)
        print(f"tp rank {rank} {run['arch']}: " + json.dumps(
            {k: res[k] for k in ("tok_s", "host_ms_a_step", "peak_gb", "serve_wall_s",
                                 "passes", "launches")}
            | {"issued": res["model"]["issued"], "staged": res["model"]["staged"]}), flush=True)
        del sess
        torch.cuda.empty_cache()
    for run in job["steps"]:
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.time()
        res = _tp_steps(dev, **run)
        res.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9, wall_s=time.time() - t1)
        out["steps"].append(res)
        print(f"tp rank {rank} {run['arch']} step-level: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("model", "shapes")}), flush=True)
    out["wall_s"] = time.time() - t0
    return out


def _tp_torchrun(phases: list) -> dict:
    """One ``torch.distributed.run`` of ``SERVE_TP_RANKS`` gloo ranks sharing
    the card for the parts of the tensor-parallel ``phases``
    (``TP_PHASES``), run one after another in the same processes, which
    start and warm up once.  Each phase's ranks' results, each with its
    rank.  The ranks' segments grow (expandable segments): 4 ranks drawing
    llama-3.2-vision's 4.2 GB f32 embedding whole at once would otherwise
    strand the freed blocks of one leaf from the next's."""
    import tempfile

    base = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    parts = {p: TP_PHASES[p] for p in phases}
    ranks = _torchrun(SERVE_TP_RANKS, {"backend": "gloo", "share_device": True, **parts}, base,
                      900, env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    return {p: [dict(rk[p], rank=rk["rank"]) for rk in ranks] for p in phases}


def phase_tp(phase: str, dev: dict, ranks: list) -> dict:
    """Check a tensor-parallel phase (``serve_tp`` or ``serve_tp_families``;
    see the module docstring; ``train_tp``: :func:`phase_train_tp`) from its
    part's ranks' results; returns rank 0's K3/K4/K5 launches over the
    serves."""
    import dataclasses

    if phase == "train_tp":
        return phase_train_tp(dev, ranks)

    from repro_torch.configs import get_config, smoke_variant

    card = f"{dev['kind']} ({dev['smi']})"
    T, B = SERVE_TP_RANKS, SERVE_TP_SLOTS
    part = TP_PHASES[phase]
    launches = {k: 0 for k in _ATTN_KERNELS}
    unheld: dict = {}

    def depth(c):
        return f"{c.n_layers}" + (f" + {c.n_encoder_layers}" if c.n_encoder_layers else "")

    for i, run in enumerate(part["runs"]):
        full = get_config(run["arch"])
        cfg = dataclasses.replace(smoke_variant(full) if run.get("smoke") else full,
                                  **run["cut"])
        first = ranks[0]["runs"][i]
        st = first["stats"]
        assert len(st["prompt_buckets"]) == 1, st["prompt_buckets"]
        bucket = st["prompt_buckets"][0]
        pre = expected_launches(cfg, "prefill", bucket, T)
        dec = expected_launches(cfg, "decode", 0, T)
        per_rank = []
        for rk in ranks:
            res = rk["runs"][i]
            label = f"{phase} {run['arch']} rank {rk['rank']}"
            _same_serve(label, res, first)
            assert res["at"] == [0, rk["rank"]] and res["layers"] == cfg.n_layers, res["at"]
            P, Dc = res["passes"]["prefill"], res["passes"]["decode"]
            want = {k: P * pre[k] + Dc * dec[k] for k in pre}
            if res["stats"]["kv_layout"] != "paged":
                want["flash_decode"] = 0          # the contiguous layout: the plain merge
            if res["launches"] != want:
                raise AssertionError(f"{label}: launches {res['launches']}, want {want} "
                                     f"({res['passes']})")
            predicted = tp_collectives(cfg, T, res["passes"], bucket, B, SERVE_TP_S_MAX)
            if res["model"]["issued"] != predicted:
                raise AssertionError(f"{label}: collectives {res['model']['issued']}, "
                                     f"predicted {predicted}")
            if res["model"]["staged"]:
                raise AssertionError(f"{label}: staged {res['model']['staged']}")
            for name, miss in _unheld(res["shapes"]).items():
                unheld.setdefault(f"{run['arch']} {name}", set()).update(miss)
            per_rank.append({"rank": rk["rank"], "tok_s": res["tok_s"],
                             "host_ms_a_step": res["host_ms_a_step"],
                             "peak_gb": res["peak_gb"], "serve_wall_s": res["serve_wall_s"],
                             "launches": res["launches"]})
        assert st["admitted"] == st["completed"] == run["options"]["requests"], st
        assert st["kv_layout"] == ("contiguous" if cfg.family == "ssm" else
                                   run["options"].get("kv_layout", "contiguous")), st
        assert all(0 <= t < cfg.vocab_size for t in first["tokens"]), "sampled id out of range"
        for k in _ATTN_KERNELS:
            launches[k] += first["launches"][k]
            if pre[k] or (dec[k] and st["kv_layout"] == "paged"):
                assert first["launches"][k] > 0, (run["arch"], k, first["launches"])
        emit({phase: {
            "run": f"{run['arch']} 1x{T}, {T} gloo ranks sharing the card", "card": card,
            "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers or None,
            "full_depth": [full.n_layers, full.n_encoder_layers or None],
            "smoke": bool(run.get("smoke")), "kv_layout": st["kv_layout"],
            "prompt_bucket": bucket, "max_new": run["options"]["max_new"],
            "admitted": st["admitted"], "decode_steps": st["decode_steps"],
            "passes": first["passes"], "kv_bytes": st["kv_bytes"],
            "collectives_a_rank": first["model"]["issued"],
            "launch_shapes": {k: first["shapes"][k] for k in _SHAPE_KEYS},
            "sample": st["sample"], "per_rank": per_rank}})
        cut = ("" if run.get("smoke") or depth(cfg) == depth(full)
               else f" (cut from {depth(full)} for the time limit)")
        size = " smoke size" if run.get("smoke") else ""
        print(f"{phase}: {run['arch']}{size} at {depth(cfg)} layers{cut} on 1x{T}: every "
              f"rank's tokens ({len(first['tokens'])}) and ServeStats equal; launches and "
              "collectives as predicted; nothing staged")
    for n, run in enumerate(part["steps"]):
        cfg = dataclasses.replace(get_config(run["arch"]), **run["cut"])
        pg = [rk["steps"][n] for rk in ranks]
        pre = expected_launches(cfg, "prefill", max(run["plens"]), T)
        dec = expected_launches(cfg, "decode", 0, T)
        want = {k: pre[k] + run["steps"] * dec[k] for k in pre}
        main = dict(want, flash_decode=0) if run["layout"] == "contiguous" else want
        label = f"{phase} {run['arch']} step-level"
        for t, r in enumerate(pg):
            if not r["finite"] or r["launches"] != main:
                raise AssertionError(f"{label}: rank {t}: launches {r['launches']}, want "
                                     f"{main}, finite {r['finite']}")
            for name, miss in _unheld(r["shapes"]).items():
                unheld.setdefault(f"{run['arch']} step-level {name}", set()).update(miss)
        one = pg[0]["vs_1x1"]
        if not one["ok"]:
            raise AssertionError(f"{label}: 1x{T} through the kernels against the 1x1 model "
                                 f"through the plain versions: max {one['max_abs']} beyond "
                                 f"rtol = atol = {one['tol']}")
        grouped = " (its gated norm in 4 groups)" if cfg.family in ("ssm", "hybrid") else ""
        line = {"run": f"{run['arch']} step-level, {depth(cfg)} layers, f32", "card": card,
                **{k: run[k] for k in ("cut", "plens", "steps", "layout")},
                "launches": pg[0]["launches"], "vs_1x1": one,
                "launch_shapes": {k: pg[0]["shapes"][k] for k in _SHAPE_KEYS}}
        print(f"{phase}: {run['arch']}'s step-level 1x{T} logits (prefill and {run['steps']} "
              f"decode steps, {depth(cfg)} layers at full width, f32, {run['layout']}) equal "
              f"the 1x1 model's{grouped} through the plain versions within "
              f"{one['max_abs']:.3g} (tol {SERVE_TP_1X1_TOL} of logits up to "
              f"{pg[0]['logit_max_abs']:.3g}), greedy agreement {one['greedy_agreement']}")
        if run.get("seq_paged"):
            S_loc = SERVE_TP_S_MAX // T
            for t, r in enumerate(pg):
                if not r["ref_bit_equal"]:
                    raise AssertionError(f"{label} paged: rank {t}: {r}")
                if r["flash_max_abs"] > SERVE_TP_PAGED_RTOL * r["logit_max_abs"]:
                    raise AssertionError(
                        f"{label} paged: K5 and the merge against the contiguous layout: "
                        f"{r['flash_max_abs']} > {SERVE_TP_PAGED_RTOL} x {r['logit_max_abs']}")
                for step, lens in enumerate(r["k5_local_lengths"]):
                    glob = [p + step + 1 for p in run["plens"]]
                    if lens != [min(max(g - S_loc * t, 0), S_loc) for g in glob]:
                        raise AssertionError(f"{label} paged: rank {t} step {step}: K5 "
                                             f"lengths {lens}")
                if r["paged_launches"] != want:
                    raise AssertionError(f"{label} paged: rank {t}: launches "
                                         f"{r['paged_launches']}, want {want}")
            assert [r["k5_local_lengths"][-1][0] for r in pg] == [24, 0, 0, 0], pg
            line["paged_launches"] = pg[0]["paged_launches"]
            print(f"{phase}: {run['arch']}'s step-level paged sequence-parallel decode equals "
                  f"the contiguous layout bit for bit through the gathered view, and through "
                  f"K5 and the merge within {max(r['flash_max_abs'] for r in pg):.3g} of "
                  f"logits up to {pg[0]['logit_max_abs']:.3g}")
        line["per_rank"] = [{k: r[k] for k in ("rank", "ref_bit_equal", "flash_max_abs",
                                               "logit_max_abs", "peak_gb", "wall_s",
                                               "k5_local_lengths") if k in r} for r in pg]
        emit({phase: line})
    if unheld:
        raise AssertionError(f"{phase}: launch shapes phase kernels does not hold: "
                             + json.dumps({k: sorted(v) for k, v in unheld.items()}))
    print(f"{phase}: every K3, K4 and K5 shape launched is one phase kernels holds; the ranks' "
          f"part {ranks[0]['wall_s']:.1f} s")
    return launches


def train_tp_launches(cfg, D: int) -> dict:
    """K1 and K2 launches a train step and rank of a dense model under remat:
    K1's inline entry once a weight use (the embedding and the unembedding
    once, a layer's 7 projections twice: forward and the rerun), the split
    K2 once (both passes) where the wire has two clients or more."""
    k2 = 1 if D > 1 else 0
    return {"sr_quant_inline": 2 + 7 * cfg.n_layers * 2, "sr_pack_keyed_scales": k2,
            "sr_pack_keyed_scaled": k2, "sr_pack_keyed": 0, "sr_pack": k2}


def train_tp_collectives(cfg, D: int, T: int, B: int, S: int) -> dict:
    """A rank's collectives in one train step of a dense model under
    sequence parallelism and remat on a ``DxT`` mesh (``B`` rows a client,
    sequence ``S``; the wire on, at two clients or more), by group, kind and
    dtype.  The model group: the forward's embedding reduce-scatter, a
    layer's two all-gathers and two reduce-scatters (compute dtype, ``(B, S,
    d)``) and the final norm's all-gather; in backward the checkpointed
    layers rerun their gathers and the attention's sum (the rerun stops at
    the last tensor backward reads, before the MLP's), every all-gather's
    transpose a reduce-scatter and every reduce-scatter's an all-gather; the
    cross-entropy's max and two sums of ``(B, c)`` f32 a chunk, forward and
    rerun; one f32 sum of the replicated leaves' parts (the norm scales) and
    the gradient norm's.  The batch group (``D > 1``): each FSDP leaf of the
    model shard's slices gathered at each use (the embedding and
    unembedding once, a layer's projections twice) and reduce-scattered
    once, in f32 at their gathered size; the wire's non-finite count
    (int64), scales' max (f32 a leaf) and codes' sum (int32) over the
    replicated leaves; the loss's and the gradient norm's f32 sums."""
    from repro_torch.models.common import fsdp_plan, is_stacked
    from repro_torch.models.model import build_model

    cd = "bfloat16" if cfg.compute_dtype == "bfloat16" else "float32"
    L, d, e = cfg.n_layers, cfg.d_model, 2 if cd == "bfloat16" else 4
    c = min(512, S)
    act, chunks, rows = B * S * d * e, S // c, B * c * 4
    model = {f"all-gather {cd}": [6 * L + 2, (6 * L + 2) * act],
             f"reduce-scatter {cd}": [5 * L + 2, (5 * L + 2) * act],
             "all-reduce max float32": [2 * chunks, 2 * chunks * rows],
             "all-reduce sum float32": [4 * chunks + 2, 4 * chunks * rows + (2 * L + 1) * d * 4
                                        + 4]}
    out = {"model": {k: {"calls": n, "bytes": b} for k, (n, b) in sorted(model.items())}}
    if D == 1:
        return out
    local = build_model(cfg).init(torch.Generator().manual_seed(0), T, device="meta")
    paths, leaves, plan = fsdp_plan(local, D)
    ag, rs, wire = [0, 0], [0, 0], [0, 0]
    for path, w, dim in zip(paths, leaves, plan):
        if dim is None:
            wire[0] += 1
            wire[1] += w.numel()
            continue
        uses = 2 if is_stacked(path) else 1
        per = w.numel() // (w.shape[0] if is_stacked(path) else 1) * 4
        n = w.shape[0] if is_stacked(path) else 1
        ag[0] += n * uses
        ag[1] += n * uses * per
        rs[0] += n
        rs[1] += n * per
    batch = {"all-gather float32": ag, "reduce-scatter float32": rs,
             "all-reduce sum int64": [1, 8], "all-reduce max float32": [1, 4 * wire[0]],
             "all-reduce sum int32": [1, 4 * wire[1]], "all-reduce sum float32": [2, 8]}
    out["batch"] = {k: {"calls": n, "bytes": b} for k, (n, b) in sorted(batch.items())}
    return out


def _sgd_step(model, axes, params, batch, bits: int = 32):
    """One ``build_train_step`` step of one client at ``bits``-wide weights,
    sgd at lr 0.05, no wire: ``(params, metrics)``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.fwq import delta_for_clients
    from repro_torch.launch.steps import SRDraws, build_train_step
    from repro_torch.optim import build_optimizer

    opt = build_optimizer("sgd", 0.05)
    ts = build_train_step(model, axes, opt, TrainConfig(learning_rate=0.05, seed=0))
    p1, _o, m = ts.fn(params, opt.init(params), batch,
                      delta_for_clients(np.array([bits] * axes.dp)), SRDraws(0, 1))
    return p1, m


def _train_tp_step_level(dev, arch: str, cut: dict) -> dict:
    """The step level of the trainer on this rank's model shard of ``1x4``:
    ``arch`` at full width, ``cut``, f32 compute, 32-bit weights; the rank's
    slices of the one init (seed 0), one step on a batch of 2 x 512 tokens
    (seed 3), the slices joined (every rank takes part).  Rank 0 then runs
    the same seed's ``1x1`` step through the plain versions (the SSM's gated
    norm in 4 groups) and holds every leaf's update to it."""
    import dataclasses

    from repro_torch.ckpt.checkpoint import gather_state
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import AxisCtx
    from repro_torch.launch.mesh import axis_ctx_for
    from repro_torch.launch.steps import build_init_fn
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config(arch), **cut, compute_dtype="float32")
    model = build_model(cfg)
    axes = axis_ctx_for(f"1x{SERVE_TP_RANKS}", group="default")
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (TRAIN_TP_BATCH, TRAIN_TP_SEQ)
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}

    def init(ax):
        return build_init_fn(model, ax, device=dev)(torch.Generator(device=dev).manual_seed(0))

    ops.reset_launches()
    p1, m = _sgd_step(model, axes, init(axes), batch)
    out = {"arch": arch, "cut": cut, "rank": axes.tp_index(), "loss": float(m["loss"]),
           "launches": {k: ops.LAUNCHES[k] for k in _TRAIN_KERNELS},
           "model": axes.model_transport.report()}
    got = gather_state({"p": p1}, p1, axes, cfg)["p"]
    del p1
    if axes.tp_index() == 0:
        one = AxisCtx()
        w0 = init(one)
        with plain_kernels(), _ssm_norm_in_groups(axes.tp):
            w1, m1 = _sgd_step(model, one, dict(w0), batch)
        worst, leaf = 0.0, None
        for p in w1:
            want = w1[p] - w0[p]
            err = float((got[p] - w0[p] - want).abs().max()) / max(float(want.abs().max()),
                                                                    1e-30)
            if err > worst:
                worst, leaf = err, p
        out["vs_1x1"] = {"worst": worst, "leaf": leaf, "tol": TRAIN_TP_1X1_TOL,
                         "ok": worst <= TRAIN_TP_1X1_TOL, "loss_1x1": float(m1["loss"]),
                         "leaves": len(w1)}
        del w0, w1
    del got
    torch.cuda.empty_cache()
    return out


def train_tp_rank(job: dict, dev, rank: int) -> dict:
    """One rank's part of phase train_tp (started by
    ``torch.distributed.run``, :func:`_tp_torchrun`): each run's ``train``
    rounds through ``Session.run_train`` (:func:`counted_rounds`: launches,
    both groups' collectives, host ms, span on the card's clock, peak a
    round; the launch counters zeroed just before the run), its groups'
    staged collectives; then the step levels (:func:`_train_tp_step_level`);
    a line on stdout each, and the part's seconds."""
    t0 = time.time()
    out = {"runs": [], "steps": []}
    for run in job["runs"]:
        spec = dict(workload="train", rounds=TRAIN_TP_ROUNDS, options={},
                    precision=dict(weights=8, comm=run["comm"]))
        sess = _train_session(spec, str(dev), layers=TRAIN_TP_LAYERS, seq=TRAIN_TP_SEQ,
                              mesh=run["mesh"])
        t1 = time.time()
        sess._ensure_train_state()
        torch.cuda.synchronize(dev)
        setup_s = time.time() - t1
        axes = sess.axes
        groups = {"model": axes.model_transport, "batch": axes.transport}
        rows: list = []
        ops.reset_launches()
        with counted_rounds(rows, dev, groups):
            hist = sess.run_train()
        res = {"mesh": run["mesh"], "at": [axes.dp_index(), axes.tp_index()],
               "layers": sess.cfg.n_layers, "setup_s": setup_s,
               "losses": [h["loss"] for h in hist], "rounds": rows,
               "launches": {k: ops.LAUNCHES[k] for k in _TRAIN_KERNELS},
               "staged": {n: dict(t.staged) for n, t in groups.items() if t is not None}}
        out["runs"].append(res)
        print(f"tp rank {rank} train {run['mesh']}: " + json.dumps(
            {k: res[k] for k in ("setup_s", "losses", "staged")}
            | {"rounds": [{k: r[k] for k in ("host_ms", "span_ms", "peak_gb", "launches")}
                          for r in rows]}), flush=True)
        del sess
        torch.cuda.empty_cache()
    for run in job["steps"]:
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.time()
        res = _train_tp_step_level(dev, **run)
        res.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9, wall_s=time.time() - t1)
        out["steps"].append(res)
        print(f"tp rank {rank} train {run['arch']} step-level: " + json.dumps(
            {k: v for k, v in res.items() if k != "model"}), flush=True)
    out["wall_s"] = time.time() - t0
    return out


def phase_train_tp(dev: dict, ranks: list) -> dict:
    """Check phase train_tp (see the module docstring) from its part's
    ranks' results; returns the trainer's K1 and K2 launches over the runs,
    summed over the ranks."""
    import dataclasses

    from repro_torch.configs import get_config

    card = f"{dev['kind']} ({dev['smi']})"
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_TP_LAYERS)
    launches = {k: 0 for k in ("sr_quant", *_TRAIN_KERNELS)}
    for i, run in enumerate(TRAIN_TP_RUNS):
        D, T = (int(x) for x in run["mesh"].split("x"))
        want_k = train_tp_launches(cfg, D)
        want_c = train_tp_collectives(cfg, D, T, TRAIN_TP_BATCH, TRAIN_TP_SEQ)
        first = ranks[0]["runs"][i]
        per_rank = []
        for rk in ranks:
            res = rk["runs"][i]
            label = f"train_tp {run['mesh']} rank {rk['rank']}"
            assert res["at"] == [rk["rank"] // T, rk["rank"] % T], (label, res["at"])
            if res["losses"] != first["losses"] or not all(map(math.isfinite, res["losses"])):
                raise AssertionError(f"{label}: losses {res['losses']}, rank 0's "
                                     f"{first['losses']}")
            for row in res["rounds"]:
                if row["launches"] != want_k:
                    raise AssertionError(f"{label} round {row['round']}: launches "
                                         f"{row['launches']}, want {want_k}")
                if row["collectives"] != want_c:
                    raise AssertionError(f"{label} round {row['round']}: collectives "
                                         f"{row['collectives']}, predicted {want_c}")
            if any(res["staged"].values()):
                raise AssertionError(f"{label}: staged {res['staged']}")
            for k in _TRAIN_KERNELS:
                launches[k] += res["launches"][k]
            per_rank.append({"rank": rk["rank"], "setup_s": res["setup_s"],
                             "rounds": [{k: r[k] for k in ("round", "loss", "host_ms", "span_ms",
                                                           "peak_gb")} for r in res["rounds"]]})
        launches["sr_quant"] += sum(rk["runs"][i]["launches"]["sr_quant_inline"]
                                    for rk in ranks)
        steps = [r for rk in per_rank for r in rk["rounds"][1:]]     # after the first
        emit({"train_tp": {
            "run": f"yi-6b {run['mesh']}, {len(ranks)} gloo ranks sharing the card",
            "card": card, "layers": TRAIN_TP_LAYERS, "full_depth": get_config("yi-6b").n_layers,
            "batch_per_client": TRAIN_TP_BATCH, "seq": TRAIN_TP_SEQ, "weight_bits": 8,
            "comm_bits": run["comm"] if D > 1 else None, "losses": first["losses"],
            "launches_a_step": want_k, "collectives_a_step": want_c, "per_rank": per_rank}})
        print(f"train_tp: yi-6b at {TRAIN_TP_LAYERS} of 32 layers on {run['mesh']}: every "
              f"rank's losses {first['losses']} equal; launches a step {want_k} and both "
              f"groups' collectives as predicted; nothing staged; after the first step "
              f"host {min(r['host_ms'] for r in steps):.1f}-{max(r['host_ms'] for r in steps):.1f}"
              f" ms, device span {min(r['span_ms'] for r in steps):.1f}-"
              f"{max(r['span_ms'] for r in steps):.1f} ms, peak "
              f"{max(r['peak_gb'] for r in steps):.2f} GB a rank")
    for n, run in enumerate(TRAIN_TP_STEPS):
        pg = [rk["steps"][n] for rk in ranks]
        label = f"train_tp {run['arch']} step-level"
        if len({r["loss"] for r in pg}) != 1:
            raise AssertionError(f"{label}: the ranks' losses differ: {[r['loss'] for r in pg]}")
        one = pg[0]["vs_1x1"]
        if not one["ok"]:
            raise AssertionError(f"{label}: leaf {one['leaf']}'s update is {one['worst']:.3g} "
                                 f"of the 1x1 step's off (tol {TRAIN_TP_1X1_TOL})")
        grouped = " (its gated norm in 4 groups)" if run["arch"].startswith("mamba") else ""
        emit({"train_tp": {"run": f"{run['arch']} step-level, {run['cut']}, f32, 1x4",
                           "card": card, "loss": pg[0]["loss"], "vs_1x1": one,
                           "launches": pg[0]["launches"],
                           "per_rank": [{k: r[k] for k in ("rank", "peak_gb", "wall_s")}
                                        for r in pg]}})
        print(f"train_tp: {run['arch']}'s 1x4 step (full width, {run['cut']['n_layers']} "
              f"layers, f32, 32-bit weights) updates all {one['leaves']} leaves as the 1x1 "
              f"step{grouped} does: worst {one['worst']:.3g} of a leaf's largest update "
              f"({one['leaf']}; tol {TRAIN_TP_1X1_TOL}); loss {pg[0]['loss']:.6f} vs "
              f"{one['loss_1x1']:.6f}")
    print(f"train_tp: the ranks' part {ranks[0]['wall_s']:.1f} s")
    return launches


COMMITTED_STORES = os.path.join(ROOT, "results")
#: Phase ``grids``: committed cells rerun through the port's ``SweepRunner``
#: on the card, each where the runner puts it (serve and train cells in a
#: subprocess, fl-sim in this process).
GRID_CELLS = (
    ("grad-comm-wire", "c150ed63d5eb042d"),            # comm 8: K2's keyed wire, int16
    ("serve-precision-ablation", "1d3e3f3f9a1c23fd"),  # weights 7: K3 on int8 codes
    ("serve-precision-ablation", "bdc1ff13700f4928"),  # weights 12: K3 on int16 codes
    ("fl-fault-grid", "51d4d2daf3b3aa9c"))             # unified_q, severe faults: K1
#: Phase ``grids_all`` (opt-in): every cell of these presets (none is a dryrun).
GRID_PRESETS = ("fl-codesign-grid", "fl-fault-grid", "fl-adaptive-grid", "grad-comm-wire",
                "serve-precision-ablation")
#: The metrics a rerun must reproduce exactly: host arithmetic (energy, time,
#: bits, bytes, scheduling, fault counters).  A dict is compared on every key
#: the expected one holds (the committed rows predate keys added later).
EXACT_FACTS = {
    "fl-sim": ("rounds", "total_energy_j", "total_time_s", "mean_cohort", "bits_mix",
               "comm_bits_mix", "retransmissions", "retx_energy_j", "rejected_updates",
               "undelivered", "dropped_midround", "program"),
    "train": ("rounds", "total_energy_j", "bits_last", "wire"),
    "serve": ("bytes_per_step_packed", "bytes_per_step_f32", "packed_vs_f32", "kv_bytes",
              "kv_bytes_contiguous", "decode_steps", "decoded_tokens", "completed",
              "admitted", "capacity_stops", "deferred_admissions", "prompt_buckets")}
#: Shown beside the committed values, never compared (the reference draws
#: with threefry, the port with Philox); the port's must be finite.
SIDE_BY_SIDE = {"fl-sim": ("final_loss", "final_acc", "losses"), "train": ("final_loss",),
                "serve": ("tok_s", "sample")}
#: The kernels a cell must launch on the card, by workload: a serve cell at
#: f32 weights packs nothing and a train cell at comm 32 quantizes no wire.
GRID_KERNELS = {"fl-sim": ("sr_quant_keyed",), "train": ("sr_pack_keyed",),
                "serve": ("quant_matmul",)}
#: The JAX reference's own facts for the fl-sim cells, rerun on the CPU
#: (``tests/sweep_reference_rerun.py``): the yardstick of every fl cell.  The
#: committed rows were written in another environment and their float sums
#: differ from these in the last 1-3 bits (ROADMAP §3, D1).
REFERENCE_RERUN = os.path.join(ROOT, "tests", "fixtures", "sweep_reference_rerun.json")
#: Facts shown side by side, not compared, with the divergence that explains
#: them (ROADMAP §3, D2): in these severe-fault cells both packages admit a
#: 2^106-damaged update in round 10 (two survivors: their median is their
#: mean).  Which updates the damaged model then makes non-finite depends on
#: its start: the reference rejects 9 from its own init, 54 from the port's
#: CPU-drawn one and 23 from its CUDA-drawn one, the card's start
#: (``tests/severe_cell_starts.py``, ``tests/test_torch_fl.py::test_severe_fault_cell_*``).
DIVERGENCES = {("685598d766e97c05", "rejected_updates"): "D2",
               ("51d4d2daf3b3aa9c", "rejected_updates"): "D2",
               ("15117c7f3f68da12", "rejected_updates"): "D2"}


def _finite(v) -> bool:
    if isinstance(v, list):
        return all(_finite(x) for x in v)
    return isinstance(v, (int, float)) and math.isfinite(v)


def compare_row(row: dict, want: dict) -> list:
    """The exact facts of ``row`` (the port's) that differ from ``want`` (the
    reference's CPU rerun of an fl cell, the committed row of another), and
    the side-by-side values that are not finite; prints them all."""
    wl, got = row["spec"]["workload"], row["metrics"]
    bad, absent, diverged = [], [], {}
    for k in EXACT_FACTS[wl]:
        if k not in want:
            absent.append(k)
            continue
        w, g = want[k], got.get(k)
        if (row["key"], k) in DIVERGENCES:
            diverged[k] = {"port": g, "reference": w, "divergence": DIVERGENCES[row["key"], k]}
            continue
        if isinstance(w, dict):
            same = isinstance(g, dict) and all(k2 in g and g[k2] == w[k2] for k2 in w)
        else:
            same = g == w
        if not same:
            bad.append(f"{k}: port {g!r} != reference {w!r}")
    side = {k: {"port": got.get(k), "committed": want.get(k)} for k in SIDE_BY_SIDE[wl]}
    for k, v in side.items():
        if v["port"] is None and not (k == "final_acc" and v["committed"] is None):
            bad.append(f"{k}: the port's value is not finite")
        elif v["port"] is not None and k != "sample" and not _finite(v["port"]):
            bad.append(f"{k}: the port's value {v['port']!r} is not finite")
    n = len(EXACT_FACTS[wl]) - len(absent) - len(diverged)
    notes = ([f"diverged: {', '.join(diverged)}"] if diverged else []) + \
        ([f"not recorded: {', '.join(absent)}"] if absent else [])
    print(f"grids {row['sweep']} {row['key']}: exact facts {'equal' if not bad else 'DIFFER'} "
          f"({n} compared{'; ' if notes else ''}{'; '.join(notes)})")
    emit({"grid_cell": {"sweep": row["sweep"], "key": row["key"], "status": row["status"],
                        "wall_s": row["wall_s"], "launches": row.get("launches"),
                        "exact": {k: got.get(k) for k in EXACT_FACTS[wl] if k not in absent},
                        "diverged": diverged, "side_by_side": side, "differences": bad}})
    return bad


def run_grid_cells(cells: list, store_dir: str, timeout_s: float = 900.0) -> list:
    """Run ``cells`` (of one or more presets) through ``SweepRunner`` on the
    card into ``store_dir``, each preset's cells as one sweep of that name
    (a store of its own); returns their rows, in order.  A sweep whose cells
    all run in a subprocess runs in a thread of its own, beside the others;
    the sweeps with cells in this process (whose launches are read from this
    process's counters) run one after another here."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.sweep import ResultsStore, Sweep, SweepRunner
    from repro_torch.sweep.runner import SUBPROCESS_WORKLOADS

    stores = {}

    def run(name):
        mine = [c for c in cells if c.sweep == name]
        sweep = Sweep(name=name, base=mine[0].spec.to_dict(),
                      extra_cells=tuple(c.spec.to_dict() for c in mine[1:]))
        assert [c.key for c in sweep.cells()] == [c.key for c in mine], name
        stores[name] = ResultsStore.for_sweep(sweep, store_dir)
        SweepRunner(sweep, stores[name], timeout_s=timeout_s, device="cuda").run()

    names = list(dict.fromkeys(c.sweep for c in cells))
    apart = [n for n in names if all(c.spec.workload in SUBPROCESS_WORKLOADS
                                     for c in cells if c.sweep == n)]
    with ThreadPoolExecutor(max_workers=max(len(apart), 1)) as pool:
        futures = [pool.submit(run, n) for n in apart]
        for n in names:
            if n not in apart:
                run(n)
        for f in futures:
            f.result()
    return [stores[c.sweep].get(c.key) for c in cells]


def check_grid_rows(rows: list) -> tuple[dict, list]:
    """Every row ``ok``, its exact facts equal to the reference's (an fl
    cell's rerun on the CPU, another cell's committed row), and its
    workload's kernels launched; returns the rows' launches summed and the
    failures."""
    from repro_torch.sweep import ResultsStore

    committed, failures, total = {}, [], {}
    with open(REFERENCE_RERUN) as f:
        reruns = json.load(f)
    for row in rows:
        name = row["sweep"]
        if name not in committed:
            committed[name] = ResultsStore(os.path.join(COMMITTED_STORES, f"sweep_{name}.jsonl"))
        if row["status"] != "ok":
            failures.append(f"{name} {row['key']}: {row['status']}: "
                            f"{json.dumps(row['metrics'])[-1500:]}")
            continue
        want = committed[name].get(row["key"])["metrics"]
        if row["spec"]["workload"] == "fl-sim":
            # the reference's rerun holds every fl fact, and the losses beside it
            want = {**reruns[row["key"]], **{k: want.get(k) for k in SIDE_BY_SIDE["fl-sim"]}}
        failures += [f"{name} {row['key']}: {d}" for d in compare_row(row, want)]
        launches, spec = row["launches"], row["spec"]
        p = spec["precision"]
        quantizes = {"serve": p["weights"] < 32, "train": p["comm"] < 32}.get(spec["workload"],
                                                                              True)
        for k in GRID_KERNELS[spec["workload"]] if quantizes else ():
            if not launches.get(k):
                failures.append(f"{name} {row['key']}: never launched {k}: {launches}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total, failures


def grid_full_width_serve(dev: dict) -> dict:
    """A one-cell ad-hoc sweep: full-width yi-6b served at phase ``serve``'s
    configuration with 4 requests, through ``execute_cell`` in this
    process; its K3/K4/K5 launches equal ``expected_launches`` times the
    prefills and decode steps the session ran.  The 4 requests fill the 4
    slots in one admission, which prefills each prompt bucket once."""
    from repro_torch.api import PrecisionPolicy, RunSpec
    from repro_torch.configs import get_config
    from repro_torch.sweep import Sweep, execute_cell

    spec = RunSpec("yi-6b", workload="serve", smoke=False, seed=0, batch=4, seq=256,
                   precision=PrecisionPolicy.lazy_int8(7),
                   options={"attn_impl": "flash", "kv_layout": "paged", "vary_prompt": True,
                            "quiet": True, **SERVE_RUNS["yi-6b"]["options"], "requests": 4})
    (cell,) = Sweep(name="grids-yi-6b", base=spec.to_dict()).cells()
    ops.reset_launches()
    t0 = time.time()
    m = execute_cell(cell.spec, "cuda")
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    assert m["admitted"] == m["completed"] == spec.batch == 4, m
    assert m["deferred_admissions"] == 0, m
    passes = {"prefill": len(m["prompt_buckets"]), "decode": m["decode_steps"]}
    cfg = get_config("yi-6b")
    pre, dec = (expected_launches(cfg, kind, 0) for kind in ("prefill", "decode"))
    want = {k: passes["prefill"] * pre[k] + passes["decode"] * dec[k] for k in pre}
    assert {k: launches[k] for k in want} == want, (passes, launches, want)
    assert m["device"] == dev["kind"] and m["decoded_tokens"] > 0, m
    json.dumps(m, allow_nan=False)
    emit({"grid_cell": {"sweep": cell.sweep, "key": cell.key, "wall_s": wall,
                        "passes": passes, "launches": launches, "expected": want,
                        "metrics": {k: m[k] for k in ("tok_s", "decode_steps", "decoded_tokens",
                                                      "admitted", "completed",
                                                      "bytes_per_step_packed", "kv_bytes")},
                        "card": f"{dev['kind']} ({dev['smi']})"}})
    return launches


#: K3's int16-code shapes in the 12-bit serve cell (yi-6b smoke: d 64, 4
#: heads of 16 over 2, d_ff 128, vocab 512; f32 activations; 2 slots, an
#: 8-token prefill bucket), with the launches the cell makes at each
#: (``tests/test_torch_sweep.py`` counts them on the CPU): (M, K, N, launches).
K3_INT16_CELL_SHAPES = ((2, 64, 64, 72), (2, 64, 128, 36), (2, 64, 512, 12), (2, 128, 64, 18),
                        (16, 64, 64, 24), (16, 64, 128, 12), (16, 128, 64, 6))


def check_quant_matmul_int16_cell() -> None:
    """K3 on int16 codes (12 bits) at the 12-bit serve cell's shapes, f32 x:
    within the K3 rows' tolerance of the plain version, bit-equal over two
    launches, timed beside the plain version, ``torch.matmul`` on the
    dequantized weight and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    lim = 2 ** 11 - 1
    for M, K, N, n in K3_INT16_CELL_SHAPES:
        codes = torch.randint(-lim, lim + 1, (K, N), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int16)
        scale = torch.tensor(1.0 / math.sqrt(K) / lim, device="cuda")
        x = torch.randn((M, K), generator=gen, device="cuda")
        got = qm.quant_matmul_cuda(x, codes, scale)
        again = qm.quant_matmul_cuda(x, codes, scale)
        want = qm.quant_matmul_plain(x, codes, scale)
        torch.cuda.synchronize()
        case = f"quant_matmul int16 M={M} K={K} N={N} x=f32"
        _check(case, got, want, 1e-4, 1e-3)
        if not torch.equal(got, again):
            raise AssertionError(f"{case}: two launches on identical inputs differ")
        w = codes.float() * scale
        b_ms, b_by = bound_ms(count.quant_matmul_cost(M, K, N, torch.float32, torch.int16))
        emit(dict(kernel="quant_matmul", case="int16 codes, 12-bit serve cell", M=M, K=K,
                  N=N, x="torch.float32", codes="torch.int16",
                  plan=list(qm.plan(M, K, N, torch.float32, torch.int16)),
                  max_abs_err=max_errs(got, want)[0],
                  kernel_ms=time_ms(qm.quant_matmul_cuda, [(x, codes, scale)]),
                  plain_ms=time_ms(qm.quant_matmul_plain, [(x, codes, scale)], iters=3,
                                   warmup=1),
                  library_ms=time_ms(torch.matmul, [(x, w)]), bound_ms=b_ms, bound_by=b_by,
                  launches_in_the_cell=n))


def phase_grids(dev: dict) -> None:
    """Committed cells (:data:`GRID_CELLS`) through the port's sweep runner
    on the card, their stores in a temporary directory; every row ``ok``
    and every exact fact equal to the committed row; then the full-width
    yi-6b cell and K3 on int16 codes at the 12-bit cell's shapes."""
    import tempfile

    from repro_torch.sweep import get_preset

    cells = [next(c for c in get_preset(name).cells() if c.key == key)
             for name, key in GRID_CELLS]
    _build.build()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-grids-") as td:
        rows = run_grid_cells(cells, td)
    total, failures = check_grid_rows(rows)
    int16 = next(r for r in rows if r["key"] == "bdc1ff13700f4928")
    if int16.get("launches", {}).get("quant_matmul") != sum(s[3] for s in K3_INT16_CELL_SHAPES):
        failures.append(f"the 12-bit cell's K3 launches: {int16.get('launches')}")
    full = grid_full_width_serve(dev)
    check_quant_matmul_int16_cell()
    for k, n in full.items():
        total[k] = total.get(k, 0) + n
    emit({"grids_launches": {"cells": {r["key"]: r.get("launches") for r in rows},
                             "yi-6b full width": full, "total": total}})
    if failures:
        raise AssertionError("grids:\n" + "\n".join(failures))


def phase_grids_all(presets: list, store_dir: str) -> None:
    """Every cell of ``presets`` through the sweep runner on the card into
    ``store_dir`` (resumable: cells already ``ok`` there are skipped), each
    row held to its committed row."""
    from repro_torch.sweep import get_preset

    cells = [c for name in presets for c in get_preset(name).cells()
             if c.spec.workload != "dryrun"]
    _build.build()
    rows = run_grid_cells(cells, store_dir, timeout_s=1800.0)
    _total, failures = check_grid_rows(rows)
    if failures:
        raise AssertionError("grids_all:\n" + "\n".join(failures))
    print(f"grids_all: {len(rows)} cells of {', '.join(presets)} ok, every exact fact "
          "equal to the reference's (DIVERGENCES shown side by side)")


#: phase roofline's main paths: (arch, cell kind, depth cut) of the steps
#: phases profile and train measure (yi-6b's trainer step: 8 layers, 4x1)
ROOFLINE_PATHS = (("yi-6b", "decode", {}), ("yi-6b", "prefill", {}),
                  ("olmoe-1b-7b", "decode", {}), ("seamless-m4t-large-v2", "decode", {}),
                  ("yi-6b", "train", {"n_layers": 8}))


def _dryrun_session(arch: str, kind: str, cut: dict, device: str = "cuda"):
    """A full-width dry-run Session at the spec, policy and mesh of the step
    phase profile (serving: lazy int8 weights, flash, 16-token pages) or
    phase train (the ``train`` run: 8-bit weights, comm 4, 4x1) measures."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.configs import get_config

    if kind == "train":
        spec = RunSpec(arch, workload="dryrun", mesh="4x1", smoke=False,
                       precision=PrecisionPolicy(**TRAIN_RUNS["train"]["precision"]),
                       options={"lr": 0.05})
    else:
        spec = RunSpec(arch, workload="dryrun", mesh="1x1", smoke=False,
                       precision=PrecisionPolicy.lazy_int8(7),
                       options={"attn_impl": "flash", "page_size": 16,
                                "pool_pages": 4 * 256 // 16})
    sess = Session(spec, device=device)
    sess.cfg = dataclasses.replace(get_config(arch), **cut)
    return sess


def roofline_of_path(arch: str, kind: str, cut: dict, got: dict | None,
                     device: str = "cuda") -> dict:
    """One main path's dry run beside its measured step: the per-device
    terms on the H100, the bound of the step as the card runs it, the
    measured device ms and the bound's share of it."""
    from repro_torch.configs.base import ShapeSpec

    sess = _dryrun_session(arch, kind, cut, device)
    got = got or {}
    if kind == "train":
        cell = ShapeSpec("train_8x512", 512, 8, "train")
        d = sess.run_dryrun(shape=cell, verbose=False)
    else:
        plen = got.get("prompt_len", 128)
        cell = (ShapeSpec(f"decode_4x256", 256, 4, "decode") if kind == "decode"
                else ShapeSpec(f"prefill_4x{plen}", plen, 4, "prefill"))
        d = sess.run_dryrun(shape=cell, verbose=False, decode_len=got.get("lengths"))
    device_ms = got.get("device_ms")
    bound_ms = d["card_bound_s"] * 1e3
    row = {"arch": arch, "kind": kind, "cell": cell.name, "mesh": d["mesh"],
           "layers": sess.cfg.n_layers, "trace_s": d["compile_s"],
           "compute_s": d["compute_s"], "memory_s": d["memory_s"],
           "collective_s": d["collective_s"], "kernel_s": d["kernel_s"],
           "dominant": d["dominant"], "bound_ms": bound_ms,
           "device_ms": device_ms if device_ms is not None else "not measured",
           "share_of_bound": bound_ms / device_ms if device_ms else "not measured",
           "kernels": d["kernels"], "host_reads": d["host_reads"],
           "decode_lengths": got.get("lengths"),
           "peak_estimate_gb": d["memory_stats"]["peak_estimate"] / 1e9}
    if kind == "train":
        row["max_memory_allocated_gb"] = got.get("peak_gb", "not measured")
    return row


def _same_records(a, b) -> bool:
    def key(r):
        return r.nodes, [c.to_dict() for c in r.collectives], r.peak_bytes
    return key(a) == key(b)


def phase_roofline(dev: dict, measured: dict, device: str = "cuda") -> None:
    """The port's dry run (``Session.run_dryrun``, ``repro_torch.roofline``)
    of each main path phases profile and train measure, at their spec,
    policy and shape, with K1-K5 counted as nodes: compute, memory and
    collective seconds on the H100 a device, the bound of the step on the
    card, the measured device ms (phases profile, train; "not measured"
    without them) and the share; the trainer step's trace high-water mark
    beside ``torch.cuda.max_memory_allocated``.  Then a smoke cell of each
    kind traced on fake CPU and fake CUDA tensors gives one record, and
    yi-6b's full-width cells trace on 1x1; across the phase nothing is
    left allocated on the card (the peak may rise by scalar constants)."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.configs.base import ShapeSpec

    if device == "cuda":
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for arch, kind, cut in ROOFLINE_PATHS:
        row = roofline_of_path(arch, kind, cut, measured.get((arch, kind)), device)
        rows.append(row)
        print(f"roofline {arch} {kind} ({row['cell']}, {row['mesh']}, {row['layers']} layers): "
              f"compute {row['compute_s'] * 1e3:.4f} ms memory {row['memory_s'] * 1e3:.4f} ms "
              f"collective {row['collective_s'] * 1e3:.4f} ms kernels "
              f"{row['kernel_s'] * 1e3:.4f} ms a device; bound on the card "
              f"{row['bound_ms']:.4f} ms, measured {row['device_ms']} ms, share "
              f"{row['share_of_bound']}")
    emit({"roofline": {"card": f"{dev['kind']} ({dev['smi']})", "paths": rows}})
    # the record does not depend on the fake device
    for kind, seq in (("decode", 32), ("prefill", 16), ("train", 16)):
        recs = []
        for fake in ("cpu", device):
            sess = Session(RunSpec("yi-6b", workload="dryrun", mesh="2x1"), device=device)
            sess.device = torch.device(fake)
            recs.append(sess.trace(ShapeSpec(f"smoke_{kind}", seq, 2, kind))[0])
        if not _same_records(*recs):
            raise AssertionError(f"roofline: the smoke {kind} cell's record differs on fake "
                                 "CPU and fake CUDA tensors")
    print("roofline: smoke decode, prefill and train cells (2x1) record alike on fake CPU "
          "and fake CUDA tensors")
    full = []
    for shape in shapes_for(get_config("yi-6b")):
        d = Session(RunSpec("yi-6b", workload="dryrun", smoke=False),
                    device=device).run_dryrun(shape=shape.name, verbose=False)
        assert d["status"] == "ok", d
        full.append({k: d[k] for k in ("shape", "compile_s", "flops_per_device",
                                       "bytes_per_device_raw", "compute_s", "memory_s",
                                       "kernel_s", "dominant", "useful_flops_ratio",
                                       "card_bound_s")}
                    | {"peak_estimate_gb": d["memory_stats"]["peak_estimate"] / 1e9})
    rise = left = "not measured"
    if device == "cuda":
        torch.cuda.synchronize()
        after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        rise, left = peak - before, after - before
        # only scalar constants may touch the card: ``torch.tensor`` under
        # FakeTensorMode keeps its (real) data beside the fake tensor
        if after != before or rise > 64 * 1024:
            raise AssertionError(f"roofline: the phase's dry runs allocated on the card "
                                 f"({before} -> {after} bytes, peak {peak})")
    emit({"roofline_full_width": {"arch": "yi-6b", "mesh": "1x1", "cells": full,
                                  "left_allocated_bytes": left, "peak_rise_bytes": rise}})
    print(f"roofline: yi-6b's {len(full)} full-width cells traced on 1x1, ok; across the "
          f"phase nothing left allocated on the card, its peak {rise} bytes higher (scalar "
          "constants)")


def phase_roofline_all(dev: dict, store_dir: str, device: str = "cuda") -> None:
    """Opt-in: every ``roofline-all-archs`` cell (32 on the 16x16 pod, one
    on 2x16x16) through the port's ``SweepRunner`` on fake CUDA tensors into
    ``store_dir`` (resumable: cells already ``ok`` there are skipped), each
    row's per-device FLOPs, model FLOPs and bytes by collective kind beside
    the reference's committed row (:func:`check_pod_row`); then every other
    arch's full-width ``shapes_for`` cells on 1x1."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
    from repro_torch.sweep.grid import get_preset
    from repro_torch.sweep.runner import ResultsStore, SweepRunner

    sweep = get_preset("roofline-all-archs")
    store = ResultsStore.for_sweep(sweep, store_dir)
    out = SweepRunner(sweep, store, quiet=True, device=device).run()
    if out["failed"]:
        raise AssertionError(f"roofline_all: pod cells failed: "
                             f"{[store.get(k)['metrics'] for k in out['failed']]}")
    refs = reference_rows()
    card = f"{dev['kind']} ({dev['smi']})"
    for stored in store.rows():
        m = stored["metrics"]
        row = pod_row(m, refs.get((m["arch"], m["shape"], m["mesh"]))) | {
            "wall_s": stored["wall_s"], "card": card}
        check_pod_row(row)
        emit({"roofline_all": row})
        ref = row["reference"]
        print(f"roofline_all {m['arch']} {m['shape']} {m['mesh']}: FLOPs "
              f"{row['flops_per_device']:.6g} (committed {ref['flops_per_device']:.6g}), "
              f"model FLOPs {row['model_flops_global']:.6g}, collective bytes "
              f"{row['collective_bytes_by_kind']} (committed "
              f"{ref['collective_bytes_by_kind']}), card bound "
              f"{row['card_bound_s']:.6g} s, traced in {row['compile_s']} s")
    print(f"roofline_all: {len(out['ran'])} pod cells run, {len(out['skipped'])} already in "
          f"{store.path}; every row held to the committed one")
    for arch in ARCH_NAMES:
        if arch == "yi-6b":
            continue
        for shape in shapes_for(get_config(arch)):
            d = Session(RunSpec(arch, workload="dryrun", smoke=False),
                        device=device).run_dryrun(shape=shape.name, verbose=False)
            assert d["status"] == "ok", d
            emit({"roofline_full_width": {k: d[k] for k in (
                "arch", "shape", "compile_s", "flops_per_device", "compute_s", "memory_s",
                "kernel_s", "dominant", "useful_flops_ratio", "card_bound_s")}})


# ----------------------------------------------------------- roofline_pod
#: phase roofline_pod: the reference's pod cells, one traced device each
#: (``Session.run_dryrun`` on a pod mesh: the model group a stand-in, the
#: batch group recorded, no process group) on fake CUDA tensors: yi-6b's
#: three full-width cells on 16x16 and mamba2-780m's train cell on 2x16x16
#: (the reference's one multi-pod row)
ROOFLINE_POD_CELLS = (("yi-6b", "16x16", "train_4k"), ("yi-6b", "16x16", "prefill_32k"),
                      ("yi-6b", "16x16", "decode_32k"), ("mamba2-780m", "2x16x16", "train_4k"))
#: the reference's committed rows of the ``roofline-all-archs`` sweep
ROOFLINE_ROWS = os.path.join(ROOT, "results", "sweep_roofline-all-archs.jsonl")
#: D4 (ROADMAP §3): the SSM families' per-device dot FLOPs within this share
#: of the reference's (its SSD scan's three-operand einsums)
SSD_FLOPS_RTOL = 1e-4


def reference_rows() -> dict:
    """``(arch, shape, mesh) -> metrics`` of the reference's committed
    ``roofline-all-archs`` rows (a data file; nothing of the JAX package is
    imported)."""
    rows = {}
    with open(ROOFLINE_ROWS) as f:
        for line in f:
            m = json.loads(line)["metrics"]
            rows[(m["arch"], m["shape"], m["mesh"])] = m
    return rows


def pod_row(d: dict, want: dict | None) -> dict:
    """A traced pod cell's report, its per-device figures beside the
    reference's committed row."""
    row = {k: d[k] for k in ("arch", "shape", "mesh", "n_devices", "compile_s", "compute_s",
                             "memory_s", "collective_s", "kernel_s", "card_bound_s",
                             "dominant", "flops_per_device", "model_flops_global",
                             "useful_flops_ratio")}
    row.update(collective_bytes_by_kind=d["collective_breakdown"]["bytes"],
               collective_counts=d["collective_breakdown"]["counts"],
               peak_estimate_gb=d["memory_stats"]["peak_estimate"] / 1e9)
    if want is not None:
        row["reference"] = {"flops_per_device": want["flops_per_device"],
                            "model_flops_global": want["model_flops_global"],
                            "collective_bytes_by_kind": want["collective_breakdown"]["bytes"]}
    return row


def check_pod_row(row: dict) -> None:
    """The committed row's figures where the port's equal them (ROADMAP §3):
    the per-device dot FLOPs (within D4 for an SSM family), the model FLOPs,
    and the FSDP and sequence-parallel gathers' and reduce-scatters' bytes
    (the train cells' all-reduces differ by D16-D18)."""
    want = row.get("reference")
    label = f"roofline_pod {row['arch']} {row['shape']} {row['mesh']}"
    if want is None:
        raise AssertionError(f"{label}: no committed row")
    got_f, want_f = row["flops_per_device"], want["flops_per_device"]
    rtol = SSD_FLOPS_RTOL if row["arch"].startswith(("mamba2", "jamba")) else 0.0
    if abs(got_f - want_f) > rtol * want_f or row["model_flops_global"] != want[
            "model_flops_global"]:
        raise AssertionError(f"{label}: FLOPs {got_f} / {row['model_flops_global']} against the "
                             f"committed {want_f} / {want['model_flops_global']}")
    # an enc-dec's reference reduce-scatters its replicated encoder input
    # where the port cuts it (D16)
    kinds = ("all-gather",) if row["arch"].startswith("seamless") else ("all-gather",
                                                                        "reduce-scatter")
    for kind in kinds:
        if row["collective_bytes_by_kind"].get(kind) != want["collective_bytes_by_kind"].get(kind):
            raise AssertionError(f"{label}: {kind} bytes {row['collective_bytes_by_kind']} "
                                 f"against the committed {want['collective_bytes_by_kind']}")


def _traced_shapes(rec) -> dict:
    """The K1 and K3-K5 shapes a traced record's kernel nodes name, as
    :func:`_held_shapes` keys them (K1's inline entry by its weight's shape)."""
    out: dict = {"quant_matmul": set(), "flash_attention": set(), "flash_decode": set(),
                 "sr_quant_inline": set()}
    for n in rec.nodes:
        if n.kernel is None:
            continue
        kv = dict(part.split("=", 1) for part in n.shape.split() if "=" in part)
        if n.op == "quant_matmul":
            out[n.op].add((int(kv["M"]), int(kv["K"]), int(kv["N"]), kv["x"]))
        elif n.op == "flash_attention":
            out[n.op].add((int(kv["BH"]), int(kv["S"]), int(kv["D"]), kv["dtype"]))
        elif n.op == "flash_decode":
            out[n.op].add(tuple(int(kv[k]) for k in ("B", "KV", "G", "hd", "page", "n_pmax"))
                          + (kv["q"], kv["pool"]))
        elif n.op == sq.INLINE_NAME:
            out["sr_quant_inline"].add(tuple(int(x) for x in n.shape.strip("(),").split(",")))
        else:
            raise AssertionError(f"roofline_pod: a traced {n.op} node phase kernels has no "
                                 "shape check for")
    return out


def _unheld_traced(rec) -> dict:
    """The traced shapes of ``rec`` phase kernels does not hold (K1's inline
    entry: ``TRAIN_TP_K1_SHAPES``)."""
    held = _held_shapes()
    held["sr_quant_inline"] = {shape for shapes in TRAIN_TP_K1_SHAPES.values()
                               for _name, shape in shapes}
    return {k: sorted(v - held[k]) for k, v in _traced_shapes(rec).items() if v - held[k]}


def _traced_cached_prefill(arch: str, cfg, policy, device, *, mesh: str, B: int,
                           bucket: int, s_max: int, page_size: int):
    """The serve's cached prefill (``steps.build_cached_prefill``, the greedy
    pick included) of ``B`` slots in the ``bucket``-token bucket, traced on
    fake tensors as one device of ``mesh``: ``(record, axes)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.api import RunSpec, Session
    from repro_torch.launch.mesh import trace_axis_ctx
    from repro_torch.launch.steps import build_cached_prefill, init_global_caches
    from repro_torch.models.model import build_model

    axes = trace_axis_ctx(mesh)
    model = build_model(cfg)
    sess = Session(RunSpec(arch, workload="dryrun", mesh=mesh, smoke=False,
                           precision=policy), device=device)
    meta = model.init(torch.Generator().manual_seed(0), axes.tp, device="meta")
    with FakeTensorMode(allow_fallback_kernels=False):
        params = sess._serving_params(meta, device, packed=policy.packed)
        caches = init_global_caches(model, axes, s_max=s_max, batch_global=B,
                                    dtype=policy.kv_cache_dtype(), device=device,
                                    page_size=page_size)
        step = build_cached_prefill(model, axes, attn_impl="flash", policy=policy)
        batch = {"tokens": torch.empty((B, bucket), dtype=torch.int32, device=device)}
        mask = torch.empty((B,), dtype=torch.bool, device=device)
        plens = torch.empty((B,), dtype=torch.int32, device=device)
        with count.recording((params, batch, caches), computation="prefill") as rec:
            step.fn(params, batch, caches, mask, plens)
    return rec, axes


def roofline_pod_tp_traces(device: str = "cuda") -> list:
    """Part (c) of phase roofline_pod: the 1x4 steps phases serve_tp and
    train_tp run on real ranks, traced as one device of the mesh.  Each
    stand-in model group's ``issued`` (kind, dtype, calls, bytes) must be
    what ``tp_collectives`` / ``train_tp_collectives`` predict for one pass
    or step (the predictors phases serve_tp and train_tp hold the card's
    ranks to), and every K1/K3/K4/K5 shape the traces record one phase
    kernels holds."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec

    rows = []
    T, B, s_max = SERVE_TP_RANKS, SERVE_TP_SLOTS, SERVE_TP_S_MAX
    serve_cfg = dataclasses.replace(get_config("yi-6b"), n_layers=SERVE_TP_YI_LAYERS)
    policy = PrecisionPolicy.lazy_int8(7)
    bucket = SERVE_RUNS["yi-6b"]["options"]["prompt_len"]

    def closed(pred: dict) -> dict:
        return {k: v for k, v in pred.items() if k != "broadcast object"}

    sess = Session(RunSpec("yi-6b", workload="dryrun", mesh=f"1x{T}", smoke=False,
                           precision=policy, options={"attn_impl": "flash", "page_size": 16}),
                   device=device)
    sess.cfg = serve_cfg
    rec, _meta = sess.trace(ShapeSpec("serve_tp_decode", s_max, B, "decode"))
    traces = [("serve_tp yi-6b decode step", rec, sess.traced_axes,
               closed(tp_collectives(serve_cfg, T, {"prefill": 0, "decode": 1}, bucket, B)))]
    rec, axes = _traced_cached_prefill("yi-6b", serve_cfg, policy, device, mesh=f"1x{T}", B=B,
                                       bucket=bucket, s_max=s_max, page_size=16)
    traces.append(("serve_tp yi-6b prefill", rec, axes,
                   closed(tp_collectives(serve_cfg, T, {"prefill": 1, "decode": 0}, bucket, B))))
    train_cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_TP_LAYERS)
    sess = Session(RunSpec("yi-6b", workload="dryrun", mesh=f"1x{T}", smoke=False,
                           precision=PrecisionPolicy(weights=8, comm=8)), device=device)
    sess.cfg = train_cfg
    rec, _meta = sess.trace(ShapeSpec("train_tp_step", TRAIN_TP_SEQ, TRAIN_TP_BATCH, "train"))
    traces.append(("train_tp yi-6b step", rec, sess.traced_axes,
                   train_tp_collectives(train_cfg, 1, T, TRAIN_TP_BATCH, TRAIN_TP_SEQ)["model"]))
    for label, rec, axes, want in traces:
        got = axes.model_transport.report()["issued"]
        if got != want:
            raise AssertionError(f"roofline_pod {label}: the traced model group issued "
                                 f"{json.dumps(got)}, the predictor {json.dumps(want)}")
        unheld = _unheld_traced(rec)
        if unheld:
            raise AssertionError(f"roofline_pod {label}: traced kernel shapes phase kernels "
                                 f"does not hold: {unheld}")
        shapes = {k: len(v) for k, v in _traced_shapes(rec).items()}
        rows.append({"trace": label, "mesh": f"1x{T}", "model_issued": got,
                     "kernel_shapes": shapes})
        print(f"roofline_pod {label} (1x{T}): the stand-in model group issued the predictor's "
              f"{sum(v['calls'] for v in got.values())} collectives exactly; kernel shapes "
              f"{shapes}, each held by phase kernels")
    return rows


def phase_roofline_pod(dev: dict, device: str = "cuda") -> None:
    """The pod meshes' dry run (see the module docstring): (a) the
    reference's pod cells traced on fake CUDA tensors as one device each,
    priced on the H100 and held to the committed rows, with nothing left
    allocated on the card; (b) a smoke cell of each kind on 2x2 recorded
    alike on fake CPU and fake CUDA tensors; (c)
    :func:`roofline_pod_tp_traces`."""
    from repro_torch.api import RunSpec, Session
    from repro_torch.configs.base import ShapeSpec

    card = f"{dev['kind']} ({dev['smi']})"
    if device == "cuda":
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    refs = reference_rows()
    rows = []
    for arch, mesh, shape in ROOFLINE_POD_CELLS:
        t0 = time.time()
        d = Session(RunSpec(arch, workload="dryrun", mesh=mesh, smoke=False),
                    device=device).run_dryrun(shape=shape, verbose=False)
        if d["status"] != "ok" or d["n_devices"] != math.prod(map(int, mesh.split("x"))):
            raise AssertionError(f"roofline_pod {arch} {shape} {mesh}: {d}")
        row = pod_row(d, refs.get((arch, shape, mesh)))
        row["wall_s"] = time.time() - t0
        check_pod_row(row)
        rows.append(row)
        print(f"roofline_pod {arch} {shape} on {mesh} (one device of {row['n_devices']}, traced "
              f"in {row['compile_s']} s): compute {row['compute_s']:.6g} s memory "
              f"{row['memory_s']:.6g} s collective {row['collective_s']:.6g} s kernels "
              f"{row['kernel_s']:.6g} s, card bound {row['card_bound_s']:.6g} s on {card}; "
              f"collective bytes {row['collective_bytes_by_kind']} (the committed row's "
              f"{row['reference']['collective_bytes_by_kind']}); FLOPs "
              f"{row['flops_per_device']:.6g} (committed "
              f"{row['reference']['flops_per_device']:.6g})")
    # (b) the record does not depend on the fake device
    for kind, seq in (("decode", 32), ("prefill", 16), ("train", 16)):
        recs = []
        for fake in ("cpu", device):
            sess = Session(RunSpec("yi-6b", workload="dryrun", mesh="2x2"), device=device)
            sess.device = torch.device(fake)
            recs.append(sess.trace(ShapeSpec(f"smoke_{kind}", seq, 4, kind))[0])
        if not _same_records(*recs):
            raise AssertionError(f"roofline_pod: the smoke {kind} cell's record on 2x2 differs "
                                 "on fake CPU and fake CUDA tensors")
    print("roofline_pod: smoke decode, prefill and train cells (2x2) record alike on fake CPU "
          "and fake CUDA tensors")
    traces = roofline_pod_tp_traces(device)
    rise = left = "not measured"
    if device == "cuda":
        torch.cuda.synchronize()
        after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        rise, left = peak - before, after - before
        if after != before or rise > 64 * 1024:
            raise AssertionError(f"roofline_pod: the phase's dry runs allocated on the card "
                                 f"({before} -> {after} bytes, peak {peak})")
    emit({"roofline_pod": {"card": card, "cells": rows, "tp_traces": traces,
                           "left_allocated_bytes": left, "peak_rise_bytes": rise}})
    print(f"roofline_pod: {len(rows)} pod cells traced, ok; nothing left allocated on the card, "
          f"its peak {rise} bytes higher (scalar constants)")


#: phase analyze: each main path's spec, analyzed on fake CUDA tensors (the
#: serving paths at full width with lazy int8 weights, flash kernels and
#: 16-token pages, their depth cut to these layers (and encoder layers) for
#: the time limit: every layer repeats the first's operations; the trainer
#: at phase train's 8 layers on 4x1, comm 8)
ANALYZE_SERVE = {"yi-6b": dict(n_layers=8), "olmoe-1b-7b": dict(n_layers=4),
                 "seamless-m4t-large-v2": dict(n_layers=6, n_encoder_layers=6)}
ANALYZE_SERVE_OPTIONS = {"attn_impl": "flash", "kv_layout": "paged", "page_size": 16,
                         "pool_pages": 64, "s_max": 256, "prompt_len": 128}
#: tests/test_kernels.py's (and tests/test_paged_kv.py's) tolerances
SPEC_TOLERANCES = {("quant_matmul", torch.float32): (1e-5, 1e-2),
                   ("quant_matmul", torch.bfloat16): (2e-2, 1e-2),
                   ("flash_attention", torch.float32): (2e-4, 2e-4),
                   ("flash_attention", torch.bfloat16): (3e-2, 3e-2),
                   ("flash_decode", torch.float32): (1e-5, 1e-5)}


def _analyze_sessions(device: str = "cuda") -> list:
    """(label, Session) of each main path phase analyze lints."""
    import dataclasses

    from repro_torch.api import PrecisionPolicy, RunSpec, Session
    from repro_torch.configs import get_config

    out = []
    for arch, cut in ANALYZE_SERVE.items():
        sess = Session(RunSpec(arch, workload="serve", smoke=False, batch=4, seq=256,
                               precision=PrecisionPolicy.lazy_int8(7),
                               options=dict(ANALYZE_SERVE_OPTIONS)), device=device)
        sess.cfg = dataclasses.replace(get_config(arch), **cut)
        out.append((f"{arch} serve ({cut['n_layers']} layers)", sess))
    run = dict(workload="train", rounds=1, precision=dict(comm=8), options={})
    out.append(("yi-6b train (8 layers, 4x1, comm 8)", _train_session(run, device)))
    return out


def coverage_mask(spec, op) -> np.ndarray:
    """The elements of operand ``op`` the spec's grid visits."""
    mask = np.zeros(op.shape, dtype=bool)
    for g in itertools.product(*map(range, spec.grid)):
        idx = op.index_map(*g)
        if idx is not None:
            mask[tuple(slice(i * b, min((i + 1) * b, n))
                       for i, b, n in zip(idx, op.block, op.shape))] = True
    return mask


def _nan_filled_launch(launch):
    """``launch()`` with the launchers' own ``torch.empty`` outputs NaN-filled:
    deterministic mode fills uninitialized float memory with NaN (warnings
    only, so nothing else it checks refuses to run), and is then put back."""
    import torch.utils.deterministic

    if not torch.utils.deterministic.fill_uninitialized_memory:
        raise AssertionError("analyze: torch.utils.deterministic.fill_uninitialized_memory "
                             "is off, so the kernels' outputs would not start as NaN")
    on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return launch()
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn_only)


def hold_spec(spec, gen) -> dict:
    """Launch the spec's kernel with its outputs starting as NaN: the
    elements written must be the spec's coverage, the plan the launcher's
    (K3: its shared memory the library's own figure), and the output the
    plain version's within the reference's tolerances."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = spec.inputs[0]
    if spec.name == "quant_matmul":
        (M, K), N = x.shape, spec.outputs[0].shape[1]
        dtype = torch.bfloat16 if spec.path == "wgmma" else torch.float32
        p = spec.plan
        assert qm.plan(M, K, N, dtype, torch.int8, sms) == p, p
        smem = _build.lib().repro_quant_matmul_smem(
            _build.DTYPE_CODES[dtype], _build.DTYPE_CODES[torch.int8], M, K, N,
            qm.PATHS[p.path], p.tile_m, p.tile_n, p.split)
        if smem != spec.smem_bytes:
            raise AssertionError(f"analyze: K3 {p} at M={M} K={K} N={N}: the spec states "
                                 f"{spec.smem_bytes} bytes of shared memory, the launch "
                                 f"takes {smem}")
        xs = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        codes = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
        scale = torch.tensor([2.0 / math.sqrt(K) / 127], device="cuda")
        outs = (_nan_filled_launch(lambda: qm.quant_matmul_cuda(xs, codes, scale)),)
        wants = (qm.quant_matmul_plain(xs, codes, scale),)
        shape = f"M={M} K={K} N={N}"
    elif spec.name == "flash_attention":
        BH, S, D = x.shape
        dtype = torch.bfloat16 if spec.path == "wgmma" else torch.float32
        causal = spec.causal
        assert fa.plan_attention(BH, S, D, dtype, causal, sms) == spec.plan, spec.plan
        q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        outs = (_nan_filled_launch(lambda: fa.flash_attention_cuda(q, k, v, causal)),)
        wants = (fa.flash_attention_plain(q, k, v, causal),)
        shape = f"BH={BH} S={S} D={D} causal={causal}"
    else:
        B, KV, G, hd = x.shape
        n_pool, page = spec.inputs[1].shape[:2]
        pt = torch.tensor(np.asarray(spec.scalars[0].values).reshape(B, -1), dtype=torch.int32,
                          device="cuda")
        lengths = torch.tensor(np.asarray(spec.scalars[1].values), dtype=torch.int32,
                               device="cuda")
        dtype = torch.float32
        assert fa.plan_decode(B, KV, G, hd, page, pt.shape[1], dtype, dtype, sms) == spec.plan
        q = torch.randn((B, KV, G, hd), generator=gen, device="cuda")
        kp, vp = (torch.randn((n_pool, page, KV, hd), generator=gen, device="cuda")
                  for _ in range(2))
        outs = _nan_filled_launch(lambda: fa.flash_decode_cuda(q, kp, vp, pt, lengths))
        racc, rm, rl = fa.flash_decode_plain(q, kp, vp, pt, lengths)
        wants = (racc, rm, rl)
        shape = f"B={B} KV={KV} G={G} hd={hd} page={page} pool={n_pool}"
    torch.cuda.synchronize()
    for op, got in zip(spec.outputs, outs):
        written = (~torch.isnan(got)).cpu().numpy()
        covered = coverage_mask(spec, op)
        if not np.array_equal(written, covered):
            raise AssertionError(f"analyze: {spec.name} ({spec.path}, {shape}) output "
                                 f"{op.name}: {int((written != covered).sum())} elements "
                                 "where what the kernel wrote is not the spec's coverage")
    rtol, atol = SPEC_TOLERANCES[(spec.name, dtype)]
    case = f"spec {spec.name} {spec.path} {shape}"
    if spec.name == "flash_decode":
        acc, m, l = outs
        _check(case + " acc/l", acc / l.clamp_min(1e-30), racc / rl.clamp_min(1e-30), rtol, atol)
        _check(case + " m", m, rm, 2e-5, 2e-5)
        _check(case + " l", l, rl, 2e-5, 2e-5)
    else:
        _check(case, outs[0], wants[0], rtol, atol)
    return {"kernel": spec.name, "path": spec.path, "shape": shape, "grid": list(spec.grid),
            "smem_bytes": spec.smem_bytes, "max_abs_err": max_errs(outs[0], wants[0])[0],
            "covered": "equal"}


def _analyze_path(sess, allowlist: str) -> dict:
    """``sess.analyze`` with each traced graph's operations counted by
    ``(op, file.py:function)`` and K4's launches in it gathered."""
    from collections import Counter

    ops_of, k4 = {}, set()
    trace = sess.trace

    def traced(shape, *a, **kw):
        rec, meta = trace(shape, *a, **kw)
        g = rec.graph
        ops_of[meta["kind"]] = Counter((o.op, o.key) for o in g.ops)
        for o in g.ops:
            if o.kind == "kernel" and o.op == "flash_attention":
                dt, shp = g.meta[o.ins[0]]
                k4.add((tuple(shp), dt, bool(o.params["causal"])))
        return rec, meta

    sess.trace = traced
    proofs: list = []
    t0 = time.time()
    findings = sess.analyze(compile=True, allowlist=allowlist, proofs=proofs)
    return {"findings": findings, "proofs": proofs, "seconds": time.time() - t0,
            "ops": ops_of, "k4": k4,
            "identities": sorted((f.rule, f.key, f.cell, f.severity, f.allowed)
                                 for f in findings),
            "proof_records": sorted(json.dumps(p, sort_keys=True) for p in proofs)}


def graph_difference(cpu: dict, cuda: dict) -> dict:
    """Per step kind, the ``(op, file.py:function)`` counts that differ
    between the fake-CPU and the fake-CUDA graph (CUDA minus CPU)."""
    out = {}
    for kind in sorted(set(cpu) | set(cuda)):
        a, b = cpu.get(kind, {}), cuda.get(kind, {})
        d = {f"{op} @ {key}": b.get((op, key), 0) - a.get((op, key), 0)
             for op, key in set(a) | set(b) if a.get((op, key), 0) != b.get((op, key), 0)}
        if d:
            out[kind] = dict(sorted(d.items(), key=lambda kv: (-abs(kv[1]), kv[0])))
    return out


def phase_analyze(dev: dict) -> None:
    """The port's static analyzer on the card (``Session.analyze``: each
    step traced on fake CUDA tensors, nothing allocated).  Each main path's
    spec: findings by rule, the wire accumulator's proof, the graph's size
    and the seconds it took; any unallowlisted error fails; the same spec
    analyzed on fake CPU tensors (as the CPU tests trace) must give the same
    findings and proofs, and where the two graphs' operations differ is
    printed.  Then every shipped ``KernelSpec`` (the reference's dims, each
    cell's, and K4 at each shape and mask the main paths' traces launch it
    at) held against its launched kernel; ``python -m repro_torch analyze
    --preset ci-tiny --workloads serve,fl-sim --fail-on error``; and the
    CPU tests' smoke trainer,
    which must find on fake CUDA tensors what it finds on fake CPU ones."""
    from collections import Counter

    from repro_torch.analyze.findings import at_or_above
    from repro_torch.analyze.runner import _kernel_cells

    allowlist = os.path.join(ROOT, "analyze_torch.toml")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rows, specs, k4 = [], {}, set()

    def add_spec(ks):
        specs.setdefault((ks.name, ks.path, ks.causal, tuple(o.shape for o in ks.operands)),
                         ks)

    cpu_sessions = dict(_analyze_sessions("cpu"))
    for label, sess in _analyze_sessions():
        got = _analyze_path(sess, allowlist)
        cpu = _analyze_path(cpu_sessions.pop(label), allowlist)
        findings, proofs = got["findings"], got["proofs"]
        errors = at_or_above(findings, "error")
        rules = Counter(f"{f.rule}{' (allowed)' if f.allowed else ''}" for f in findings)
        wire = [{k: p[k] for k in ("name", "dtype", "n", "worst_sum", "headroom_bits", "ok")}
                for p in proofs if p.get("kind") in ("psum", "reduce-scatter")]
        sizes = {k: sum(c.values()) for k, c in got["ops"].items()}
        cpu_sizes = {k: sum(c.values()) for k, c in cpu["ops"].items()}
        diff = graph_difference(cpu["ops"], got["ops"])
        alike = (got["identities"] == cpu["identities"]
                 and got["proof_records"] == cpu["proof_records"])
        row = {"path": label, "seconds": got["seconds"], "graph_ops": sizes,
               "findings": dict(rules), "wire_proofs": wire,
               "unallowlisted_errors": [f.format() for f in errors],
               "cpu_seconds": cpu["seconds"], "cpu_graph_ops": cpu_sizes,
               "cpu_alike": alike, "cuda_minus_cpu_ops": diff}
        rows.append(row)
        print(f"analyze {label}: {got['seconds']:.1f} s, graph ops {sizes}, findings "
              f"{dict(rules)}, wire proofs "
              f"{[(p['name'], p['worst_sum'], p['headroom_bits']) for p in wire]}")
        print(f"analyze {label} on fake CPU tensors: {cpu['seconds']:.1f} s, graph ops "
              f"{cpu_sizes}, findings and proofs {'alike' if alike else 'DIFFERENT'}; "
              f"operations CUDA minus CPU: {json.dumps(diff)[:1500]}")
        if errors:
            raise AssertionError(f"analyze {label}: unallowlisted errors\n"
                                 + "\n".join(f.format() for f in errors))
        if not alike:
            raise AssertionError(
                f"analyze {label}: fake CPU and fake CUDA tensors find differently:\n"
                f"cuda {got['identities']} {got['proof_records']}\n"
                f"cpu {cpu['identities']} {cpu['proof_records']}")
        k4 |= got["k4"]
        for ks in _kernel_cells(sess):
            add_spec(ks)
    for (BH, S, D), dt, causal in sorted(k4):
        add_spec(fa.attention_spec(BH, S, D, dtype=getattr(torch, dt), causal=causal))
    from repro_torch.analyze.kernel_check import shipped_kernel_specs

    for ks in shipped_kernel_specs():
        add_spec(ks)
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("analyze: the analyses allocated on the card")
    gen = torch.Generator(device="cuda").manual_seed(26)
    t0 = time.time()
    held = [hold_spec(ks, gen) for ks in specs.values()]
    print(f"analyze: {len(held)} KernelSpecs held against their kernels in "
          f"{time.time() - t0:.1f} s: {sorted(Counter((h['kernel'], h['path']) for h in held).items())}; "
          f"K4 at the main paths' {len(k4)} launch shapes: {sorted(k4)}")
    from repro_torch.__main__ import main as repro_main

    t0 = time.time()
    out = io.StringIO()
    # the gate's cells that run; its two pod dry-run cells gate in the CPU
    # tests (test_analyze_ci_tiny_runs_on_the_cpu), for the time limit
    gate = ["analyze", "--preset", "ci-tiny", "--workloads", "serve,fl-sim", "--fail-on",
            "error", "--allowlist", allowlist]
    with contextlib.redirect_stdout(out):    # python -m repro_torch analyze, in this process
        rc = repro_main(gate)
    cli_s = time.time() - t0
    print(f"analyze: python -m repro_torch {' '.join(gate[:7])}: rc "
          f"{rc} in {cli_s:.1f} s; {out.getvalue().strip().splitlines()[-1:]}")
    if rc != 0:
        raise AssertionError(f"analyze: the ci-tiny gate failed\n{out.getvalue()[-3000:]}")
    from repro_torch.api import RunSpec, Session

    # the CPU tests' 4x1 comm-8 smoke trainer (tests/analyze_reference.py)
    smoke = RunSpec.from_dict({"arch": "yi-6b", "workload": "train", "mesh": "4x1",
                               "smoke": True, "batch": 1, "seq": 16, "precision": {"comm": 8}})
    t0 = time.time()
    got = {device: _analyze_path(Session(smoke, device=device), allowlist)
           for device in ("cpu", "cuda")}
    if any(got["cpu"][k] != got["cuda"][k] for k in ("identities", "proof_records")):
        raise AssertionError(f"analyze: the smoke trainer finds differently on fake CPU and "
                             f"fake CUDA tensors: {got}")
    smoke_s = time.time() - t0
    by_name = Counter()
    for (op, _key), n in got["cuda"]["ops"]["train"].items():
        by_name[op] += n
    print(f"analyze: the smoke trainer (4x1, comm 8) finds alike on fake CPU and fake CUDA "
          f"tensors ({smoke_s:.1f} s); operations CUDA minus CPU: "
          f"{graph_difference(got['cpu']['ops'], got['cuda']['ops'])}; its graph's "
          f"operations by name under torch {torch.__version__}: "
          f"{json.dumps(dict(sorted(by_name.items())))}")
    emit({"analyze": {"card": f"{dev['kind']} ({dev['smi']})", "paths": rows,
                      "specs_held": held, "ci_tiny_s": cli_s, "smoke_cpu_vs_cuda_s": smoke_s}})


PHASES = ("device", "build", "kernels", "serve", "profile", "consistency", "fl", "train",
          "dist", "serve_dist", "serve_tp", "serve_tp_families", "train_tp", "roofline",
          "roofline_pod", "analyze", "grids")
#: run only when named in ``--phases``
EXTRA_PHASES = ("sweep", "decode_sweep", "attn_sweep", "train_profile", "grids_all",
                "roofline_all")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--src", default=SRC, help="the port's source tree (read at import)")
    ap.add_argument("--presets", default=",".join(GRID_PRESETS),
                    help="phase grids_all: the sweep presets to rerun")
    ap.add_argument("--store-dir", default=os.path.join(ROOT, "results", "torch"),
                    help="phases grids_all and roofline_all: where the port's sweep "
                    "stores go")
    ap.add_argument("--dist-worker", default=None,
                    help="phase dist's ranks run this script with their job file")
    args = ap.parse_args(argv)
    if args.dist_worker:
        dist_worker(args.dist_worker)
        return 0
    phases = args.phases.split(",")
    t_start = time.time()
    dev = phase_device()
    print(f"chip_smoke: the port from {args.src}")
    table: dict = {}
    measured: dict = {}         # phases profile and train -> phase roofline
    launches = {name: 0 for name in KERNELS}
    launches_of = {}
    tp_ranks: dict = {}         # the tensor-parallel phases' parts, one torchrun
    runs = (("build", phase_build), ("kernels", lambda: phase_kernels(table)),
            ("sweep", lambda: phase_sweep(dev)), ("decode_sweep", lambda: phase_decode_sweep(dev)),
            ("attn_sweep", lambda: phase_attn_sweep(dev)),
            ("serve", lambda: launches_of.update(serve=phase_serve(dev))),
            ("profile", lambda: phase_profile(dev, measured)),
            ("consistency", phase_consistency),
            ("fl", lambda: launches_of.update(fl=phase_fl(dev))),
            ("train", lambda: launches_of.update(train=phase_train(dev, measured))),
            ("dist", lambda: launches_of.update(dist=phase_dist(dev, table))),
            ("serve_dist", lambda: launches_of.update(serve_dist=phase_serve_dist(dev))),
            *((p, lambda p=p: launches_of.update({p: phase_tp(p, dev, tp_ranks[p])}))
              for p in TP_PHASES),
            ("roofline", lambda: phase_roofline(dev, measured)),
            ("roofline_pod", lambda: phase_roofline_pod(dev)),
            ("analyze", lambda: phase_analyze(dev)),
            ("roofline_all", lambda: phase_roofline_all(dev, args.store_dir)),
            ("train_profile", lambda: phase_train_profile(dev)),
            ("grids", lambda: phase_grids(dev)),
            ("grids_all", lambda: phase_grids_all(args.presets.split(","), args.store_dir)))
    for name, run in runs:
        if name in phases:
            if name in TP_PHASES and not tp_ranks:
                named = [p for p in TP_PHASES if p in phases]
                t0 = time.time()
                tp_ranks.update(_tp_torchrun(named))
                print(f"chip_smoke: the tensor-parallel ranks (the parts of phases "
                      f"{', '.join(named)}) took {time.time() - t0:.1f} s")
            t0 = time.time()
            run()
            print(f"chip_smoke: phase {name} took {time.time() - t0:.1f} s")
    if "serve" in launches_of:
        launches = launches_of["serve"]
    for phase in ("serve_dist", "serve_tp", "serve_tp_families"):
        for name, n in launches_of.get(phase, {}).items():
            launches[name] += n         # K3, K4, K5 on the sharded paths too
    launches.update(launches_of.get("fl", {}))
    if "train" in launches_of:
        # K1 runs on both paths: its count is the sum of the two phases' runs
        train_launches = launches_of["train"]
        launches["sr_quant"] += train_launches["sr_quant"]
        for k in ("sr_quant_inline", "sr_pack", "sr_pack_keyed"):
            launches[k] = train_launches[k]
    launches.update(launches_of.get("dist", {}))
    for name, n in launches_of.get("train_tp", {}).items():
        launches[name] += n             # K1 and K2 on the tensor-parallel trainer too
    rows = []
    for name, meta in KERNELS.items():
        r = table.get(name, {})
        rows.append(dict(name=name, **meta, launches=launches.get(name, 0),
                         max_abs_err=r.get("max_abs_err"), ms=r.get("kernel_ms"),
                         plain_ms=r.get("plain_ms"), bound_ms=r.get("bound_ms"),
                         bound_by=r.get("bound_by"), library_ms=r.get("library_ms")))
    print(f"chip_smoke: {time.time() - t_start:.1f} s of command time (phases "
          f"{','.join(phases)})")
    print(dev["smi"])
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
