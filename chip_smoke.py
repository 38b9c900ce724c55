#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 off.
2. build: every kernel of the port from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all at once, with ptxas's register and spill report.
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main paths' shapes and at edge cases: flash attention
   (head dims 64, 128 and 256, and MLA's q / k at 192 with v at 128, which
   must raise for a pair the kernel is not built for), the SSD scan (y and
   the final state) and
   the RG-LRU scan (bf16 cases also against the plain version on the same
   bf16 inputs, output for output).  bf16 runs one kernel at every head
   dim (wgmma fed by TMA, a persistent block an SM), checked at every
   ragged, windowed, small-grid and fused-view case of ``attention_cases``
   and launched twice on each case's inputs, the two outputs bitwise
   equal; MLA's pair has a kernel of its own in fp32 (register-blocked on
   the CUDA cores); Whisper large-v3's head dim 64 is timed in both types.  The SSD scan's bf16 design (tensor cores) is held at every bf16
   case, with ptxas's registers and spills beside its time and the worst
   error of the bf16 cases.  At the main shapes it times the
   kernel's wrapper, the kernels alone where the wrapper prepares their
   inputs (the SSD scan), the plain version, the bound, and one library
   call where one computes the same function
   (``scaled_dot_product_attention``, a yardstick the port never calls).
   Times are device times (calls captured in a CUDA graph and replayed);
   the wrapper's time issued from Python call by call stands beside.  At
   each main shape the CUDA kernels a call are counted (``torch.profiler``)
   and held: one a flash-attention or RG-LRU wrapper call, and of the SSD
   kernel alone three in fp32 and two in bf16; these measured counts are
   the ``kernels`` line's ``cuda_launches_per_call``.  The RG-LRU kernel
   must build without spills; so must every flash-attention kernel.
4. serve: full-width, full-depth Qwen2-1.5B (28 layers), then Mamba2-370M
   (48 layers) and RecurrentGemma-9B (38 layers), each fp32 with random
   weights from seed 0 and freed before the next, each answering 4 prompts
   of 512 tokens and generating 32 tokens each.  The kernel counts are set
   to 0 just before each model's run and read just after; prefill must
   launch each kernel once per layer that holds it (flash 28 for Qwen, SSD
   48 for Mamba2, RG-LRU 26 and flash 12 for RecurrentGemma) and decode
   none, the teacher-forced decode logits must agree with prefill's, and
   prefill must agree with the plain path (policy ``ref``) on the card.
   Then "where the time goes" for each model.  Then the same prompts
   prefilled in bf16 through ``build_prefill_step``, on the model's
   weights cast to bf16 (``A_log``, ``dt_bias`` and ``lam`` kept fp32):
   flash 28 / 0 / 12, SSD 0 / 48 / 0 and RG-LRU 0 / 0 / 26 launches and
   none plain, the last position's logits no farther from the fp32
   prefill's than ``BF16_VS_FP32_RATIO`` times the distance of the bf16
   prefill through the plain versions, and against that plain bf16
   prefill (recorded); Mamba2's every SSD call of one more bf16 prefill
   against the plain version on that call's own inputs, at phase 3's
   tolerance; the prefill's time, peak memory, device busy share and the
   SSD scan's share of its device time.
5. graph-IR training (``block_program`` -> ``Program.compile_train`` ->
   ``Session.train_step`` -> ``TorchExecutor``): full-width Qwen2-1.5B
   blocks (2 layers, batch 4, seq 512, weights from seed 0 with numpy)
   under dp2 x tp2, four virtual devices stacked as rows on the one GPU,
   three steps.  B1 must launch once per layer per step (the wrapper's
   count, against the lowered graph's layers x attention classes), step
   1's loss and every gradient must agree with the port's
   ``SimulatorExecutor`` run in numpy on the host at the same size (in a
   child process that ``main`` starts before phase 1, so that its minutes
   on the host run beside phases 1 to 4 on the card; loss
   rtol 1e-5, gradients atol 1e-6 and rtol 2e-4 as ``tests/test_archs.py``
   holds the graph IR, and each gradient's normwise relative error at most
   2e-4, the key biases' excepted: at the full vocabulary every gradient
   lies below that atol, and the key-bias gradient is zero), and
   the loss must be finite and change from step to step.  Then where the
   step's time goes (host clock with the device synchronized at each
   boundary, and ``torch.profiler``), peak memory, and B1 at this path's
   shape against its plain version, its bound and SDPA.  Last, reduced
   Llama under tp2 x pp2 with two microbatches (1f1b): B1 once per layer
   per microbatch, and the same agreement with the simulator.
6. the production trainer (``repro_torch.launch.train``): full-width
   Qwen2-1.5B cut to 7 of its 28 layers and Mamba2-370M to 6 of its 48,
   and RecurrentGemma-9B at full width cut to one (rec, rec, attn)
   superblock (``TRAIN_ARCHS``), each at batch 8, seq
   512, 2 microbatches, remat, AdamW fp32, TF32 off, and freed before the
   next.  ``launch.train.main`` runs three steps: each kernel must launch
   layers x microbatches x 2 times a step (the forward and the remat
   recompute; the backward runs the plain versions), losses and gradient
   norms finite.  Two steps from one seeded init through the kernels and
   through the plain versions (policy ``ref``) must agree: the losses
   within rel 1e-5, every step-1 gradient within normwise 1e-3, every
   parameter after step 2 within normwise 1e-4 (leaves that start at zero
   excepted).  Ten steps on ``tests/test_training.py``'s learnable batch
   must end below their first loss.  Then where the last of them, profiled,
   spends its device time by the program's spans (``repro_torch.spans``:
   forward, backward with the remat recompute inside it, AdamW; kernels
   matched to spans by launch time), the device's busy share
   (``torch.profiler``), and each kernel's plain-recompute backward per
   call (device time).
7. elastic training and dynamic switching on ``TorchExecutor`` (cuda),
   every switch migrating weights and AdamW m/v through the torch comm
   lowering.  (a) The probe traces of ``repro/runtime/selftest.py``
   (``elastic:trace/4to2``, ``2to4``, ``hetero``; 6 steps, 2
   microbatches), a kill + join landing mid-transition and a crash after a
   checkpoint resumed on another device set: weights, m and v bitwise the
   port's uninterrupted reference run on its numpy simulator, losses rtol
   1e-5, the selftest's transition kinds.  (b) Phase 5's program, weights
   and feeds through ``ElasticDriver``: dp2 x tp2 on devices 0-3, tp2 on
   0-1 from step 1, dp2 x tp2 again from step 2.  Each switch's weights, m
   and v bitwise the simulator's migration of the same state; each step's
   B1 launches equal to the lowered graph's dispatches; the losses within
   rtol 1e-5 of phase 5's uninterrupted run, and after step 3 each weight
   within normwise 1e-4 and each m and v within 2e-4 of its state (phase
   6's limits; the key biases' m and v left out, their gradient being
   zero).  Per switch: messages, MB, planning and wall ms, the split into
   lowering, packing + copy to the device, row moves and copy back +
   unpack, and the grow's device-busy share (``torch.profiler``); step ms
   under each strategy, peak memory.  (c) The strategy search's validator
   with ``executors=("sim", "torch")`` on the card: every executed
   candidate bit-exact.
8. the async MPMD pipeline executor (``api.AsyncExecutor``: one program
   per (virtual stage, phase), each virtual stage on its own CUDA stream,
   the channels on one more).  (a) The torch versions of the reference's
   ``async:pipeline/{2,4,8}`` (Y and L at m 1, 2, 4 x 1f1b, gpipe,
   interleaved) and ``async:train/4`` cases (pipe4 training at four (m,
   kind), the zigzag v=2 at m 1, 2, 4), async and ``serialize=True``,
   bitwise against the port's ``SimulatorExecutor``, with the lowering's
   program and channel counts.  (b) Llama-32B blocks at published widths
   (2 layers, one a stage, weights and feeds from seed 0 with numpy)
   under tp2 x pp2, 2 microbatches of 2 x 512, one 1F1B step's
   ``run_schedule`` through ``TorchExecutor``, ``AsyncExecutor``,
   ``AsyncExecutor(serialize=True)`` and a profiled ``AsyncExecutor``: the
   loss and every gradient shard of every microbatch bitwise equal across
   them, B1 launched layers x microbatches times a run (the lowered
   graph's dispatches x 4), peak memory under the card's; printed: pack,
   dispatch loop (wall - pack - fetch) and fetch times, the overlap
   fraction 1 - async / serialized of the loop, the first ticks' device
   times on each stage (events), the profiled run's kernel busy time over
   all streams, kernel time summed over the streams and the host syncs
   that ``torch.cuda.set_sync_debug_mode("warn")`` reports; then B1 at
   this path's shape against its plain version, its bound and SDPA.
9. the rest of the model stack, each config at published widths, fp32,
   random weights from seed 0, batch 4, generating 32 tokens, freed before
   the next: DeepSeek-V2 (2 of 60 layers: the dense layer 0 and one MoE
   layer; MLA) and Grok-1 (1 of 64 MoE layers) on 512-token prompts,
   Qwen2-VL (2 of 80 layers; embedding inputs, a 16 x 16 image grid and
   text with their M-RoPE ids) on 512, Whisper large-v3 (8 of its 32
   encoder layers over 1500 audio frames, 8 of its 32 decoder) on 384.
   Prefill must launch B1 once per decoder self-attention layer (2, 1, 2,
   8) and decode none; the teacher-forced decode must agree with prefill
   (atol 2e-3, rtol 1e-3, same argmax).  MoE is served from a copy under
   ``moe.exact`` with the same weights, since at capacity factor 1.25 a
   4-token decode step keeps one assignment an expert; prefill of the
   published config through the kernels must agree with the plain
   versions on the prompts none of whose tokens is routed differently in
   any MoE layer, and at most 1% of the tokens may be.  Prefill ms,
   decode tok/s, peak memory and the device's busy share (the published
   config's prefill and decode step), and B1 at Grok-1's, Qwen2-VL's and
   Whisper's prefill shapes against its plain version, its bound and SDPA.
10. ranks sharing the card (``torch.distributed`` over gloo, every
   payload staged through host memory; NCCL refuses two ranks on one GPU
   and runs only where there is a GPU per rank).  (a) The rank selftest
   (``python -m repro_torch.runtime.selftest`` under
   ``runtime.harness.run_ranks``): the comm and async cases at 2 ranks,
   the comm, api, async and search cases at 4: every CommStep kind on
   normal (exact) and integer (fast) shards, hsplits, the round trips,
   the grouped-reduce and fusion tiers, the api sessions, pipelines and
   train steps (1F1B, GPipe, interleaved, the hsize=2 gradient path), the
   switch and the three elastic traces, the async MPMD executor on ranks
   (``api.DistAsyncExecutor``: one pipeline stage per rank, async and
   serialized, pipelines and training incl. the v=2 zigzag) and the
   strategy search validating its top three candidates on ranks, bitwise
   the port's simulator in every rank; the messages, collectives and
   staged bytes per case.  (b) Phase 5's
   program on 4 ranks through ``api.DistExecutor``, each rank rebuilding
   phase 5's weights and feeds from seed 0, ``DIST_STEPS`` (1) step: B1
   twice a step on every rank (8 in all) at q (2, 6, 512, 128), the
   losses within rtol 1e-5 of phase 5's and the weights, m and v after
   the last step within phase 7's limits of phase 5's state after the
   same step (which ``main`` writes to a
   temporary directory after phase 7), and whether they came out
   bitwise.
   (c) In the same launch, the same blocks under the hsize=2 dp2|tp2
   strategy (``runtime.selftest.hetero_block_strategy``: dp2 on devices
   0-1, tp2 on 2-3, each on half the batch), ``DIST_STEPS`` steps: the
   gradient plans
   (a bottom AR, then a top SplitAR), B1 twice a step on every rank at q
   (1, 12, 512, 128) on ranks 0-1 and (2, 6, 512, 128) on ranks 2-3, the
   losses and every part of the state against the box it covers of phase
   5's global value (formed once phase 5's replicas agree bitwise), under
   (b)'s limits.  For (b) and (c) each rank's step split (pack, compute,
   comm into host staging and exchanges, fetch, AdamW), traffic, plan
   tiers and peak memory.  (d) In the same launch, once (c)'s Session is
   dropped: phase 5's blocks under tp2 x pp2 (one layer a stage; the q/k/v
   biases left out, since the graph IR cannot microbatch their lift onto
   the activations; the tied head makes two chunks a device, so the 1F1B
   timetable is the interleaved one), one step of 2 microbatches of 2 x
   512 through ``run_schedule``, fetching the loss and every gradient of
   every microbatch, on ``api.DistAsyncExecutor`` (a real 4-rank pipeline)
   and then on ``api.DistExecutor`` (the microbatches in turn): bitwise
   between the two, within phase 5's limits of the stacked
   ``api.AsyncExecutor`` run of the same program on rank 0's card after
   the rank runs (whether bitwise is recorded), B1 once a microbatch on
   every rank at q (2, 6, 512, 128); each rank's split (pack, dispatch
   loop, comm into staging and exchanges, fetch), traffic, card and host
   peaks and its ticks' device times, and the overlap 1 - async loop /
   rank executor's loop.  (e) In the same launch, once (d)'s state is
   freed: one DeepSeek-V2 MoE layer at published widths (160 routed
   experts top-6 at capacity factor 1.25, 2 shared, d_expert 1536), 4096
   tokens, fp32, through ``apply_moe`` under the active (data=1, model=4)
   mesh of the ranks (``launch/moe_ep.py``): each rank builds only its 40
   experts, each from its own seed; routing (``top_e``, ``keep``) bitwise
   the single-process dispatch's on every rank, y within normwise 1e-5 and
   aux within 1e-6 relative of rank 0's single-process capacity dispatch
   (which builds all 160), and the bytes staged for the one all-reduce
   equal to the dry run's all-reduce bytes for that layer and mesh; the
   times and each rank's card peak.  Then B1 at the three rank shapes
   against its plain version, its bound and SDPA.
11. production dry run (after phase 12, before phase 10): child processes
   started after phase 5 (once its reference child has ended) run on the
   host, with fake tensors and a fake
   process group (nothing allocated, no card touched): (a) the roofline of
   every applicable assigned arch x input shape on 16 x 16 with this
   card's constants (``launch/roofline.py``), (b) the full dry runs of
   Qwen2-1.5B and DeepSeek-V2 x train_4k (``launch/dryrun.py``), (c) the
   anchor: phase 6's Qwen2-1.5B step on a 1 x 1 mesh, whose predicted peak
   must lie within 20% of phase 6's measured peak of step 2 through the
   plain versions, and the MFU its FLOPs and that measured step give, and
   phase 10 (e)'s layer's collective bytes; the same 1 x 1 dry run of each
   of phase 12's configs against its measured plain step-2 peak, held to
   20% for Qwen2-VL and Whisper and recorded for the MoE families (the dry
   run's DTensor MoE stands in for the capacity dispatch).
12. (after phase 9, before phase 11) phase 9's families trained through
   ``repro_torch.launch.train`` at published widths (``FAMILY_TRAIN``):
   DeepSeek-V2 cut to its dense layer 0 and one MoE layer of 64 of its
   160 routed experts (``--layers 2 --experts 64``), Grok-1 to one layer
   of 4 of its 8 experts, Qwen2-VL to 2 layers, Whisper large-v3 to 8 of
   its 32 encoder and 8 of its 32 decoder layers at 384 decoder positions;
   phase 6's batch 8, 2 microbatches, remat, AdamW
   fp32, each freed before the next.  (a) ``launch.train.main`` for three
   steps: B1 launched decoder self-attention layers x microbatches x 2 a
   step (8, 4, 8, 32; Whisper's encoder and cross-attention take the
   plain path), losses finite and changing, gradient norms finite; the
   peak, step ms and tok/s.  (b) Two steps from one init through the
   kernels and through the plain versions, phase 6's limits; with MoE each
   call's routing recorded in both runs, at most 1% of a step's tokens
   routed differently, and from a step with such a token on the loss
   within FLIP_LOSS_RTOL and gradients, m and v within FLIP_NORMWISE.  (c)
   On the learnable batch (in the config's input kind) the loss falls
   within phase 6's ten steps, stopping once it has; the second step
   profiled for the device's busy share and phase 6's split by the
   program's spans.  (d) B1's plain-recompute
   backward per call at the config's shape (MLA's q/k 192 and v 128).
13. the training line, the elastic line, the pipeline line, the families
   line (phases 9 and 12), the ranks line, the production line, the
   kernels line, then the card line, then the result line.

Needs a visible CUDA device and the repository's ``src/`` beside it; it
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
#: tensor cores, bf16 on the tensor cores, HBM3 bandwidth.  A bound takes
#: the rate of the inputs' type, whatever the kernel computes in.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: (atol, rtol) of the scans, as tests/test_kernels.py holds the Pallas
#: kernels to their oracles
SSD_TOL = {"float32": (2e-4, 5e-2), "bfloat16": (2e-1, 5e-2)}
#: each SSD call of phase 4's bf16 Mamba2 prefill against the plain version
#: on its own inputs, y and the state normwise: bf16's unit roundoff.  y's
#: own rounding to bf16 is at most 2^-9 an element, P's to bf16 (each term
#: within 2^-9) averages out over a chunk's terms, and the carried state
#: and the dt-scaled x are split into bf16 hi + lo (~2^-16)
SSD_PATH_NORMWISE = 2.0 ** -8
#: CUDA kernels one call of the SSD kernel alone runs, by type (fp32: chunk
#: states, state pass, outputs; bf16: chunk states with the carry, outputs)
SSD_CUDA_LAUNCHES = {"float32": 3, "bfloat16": 2}
# phase 4's bf16 prefill, the last position's logits normwise: the prefill
# through the kernels may lie at most BF16_VS_FP32_RATIO times as far from
# the fp32 prefill on the same weights as the bf16 prefill through the plain
# versions does.  The two bf16 runs round at other places, and over 28-48
# layers of random weights they drift apart by bf16's own error (Mamba2-370M
# on an H100: 5.2e-2 apart, each 6.4-6.5e-2 from fp32), so no flat limit on
# their own distance both passes them and means much; a right kernel adds
# nothing to the distance from fp32 (ratios 0.98-1.02 read), a wrong one
# adds its own error to it
BF16_VS_FP32_RATIO = 1.2
RGLRU_TOL = {"float32": (1e-4, 3e-2), "bfloat16": (1e-1, 3e-2)}
#: the largest share of bf16 RG-LRU outputs that may differ from the plain
#: version on the same bf16 inputs.  Both round i x to bf16 and scan in
#: fp32 in other orders, so a few outputs land on the other side of a bf16
#: rounding step (~0.03% in a CPU simulation); an i x kept in fp32 moves
#: ~30% of them.
RGLRU_BF16_MISMATCH = 0.01
ARCHS = ("qwen2-1.5b", "mamba2-370m", "recurrentgemma-9b")
BATCH, PROMPT, GEN = 4, 512, 32
#: phase 5: graph-IR training of full-width Qwen2-1.5B blocks
IR_LAYERS, IR_BATCH, IR_SEQ = 2, 4, 512
#: step 1 against the simulator: the tolerance ``tests/test_archs.py``
#: holds the graph IR's loss and gradients to ...
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 2e-4
#: ... and, because at the full 151936-token vocabulary every gradient
#: lies below that atol (the loss is a mean of probabilities near 1/vocab),
#: a normwise bound on each gradient's relative error as well (key biases
#: excepted: their gradient is mathematically zero)
GRAD_NORM_RTOL = 2e-4
#: phase 8: full-width Llama-32B blocks under tp2 x pp2 (one layer a
#: stage), 2 microbatches of 2 x 512: 1F1B's warm-up, a forward and
#: backward in turn on the last stage, and cool-down.  Each run fetches
#: every microbatch's 6 GB of gradients to the host, so the count is the
#: run's host time (at 4 the fetch took 13 s of a 20 s run)
PP_LAYERS, PP_BATCH, PP_MICRO = 2, 4, 2
#: phase 8's runs in order: each executor once (the first run pays the
#: process's first use of each kernel), then one async run under
#: ``torch.profiler`` and ``torch.cuda.set_sync_debug_mode("warn")``
PP_RUNS = ("torch", "serialized", "async", "profiled")
#: phase 6: the production trainer (``launch/train.py``), each config at
#: published widths: (arch, layers or None for full depth).  RecurrentGemma
#: keeps one (rec, rec, attn) superblock: its full 10.4 B parameters need
#: ~167 GB of fp32 params, grads, m and v, more than one 80 GB card.
#: Qwen2-1.5B keeps 7 of its 28 layers and Mamba2-370M 6 of its 48, to
#: keep the whole script well inside its 1200 s limit (Mamba2's step is
#: bound by the host's launches, so its depth is the host time it costs)
TRAIN_ARCHS = (("qwen2-1.5b", 7), ("mamba2-370m", 6),
               ("recurrentgemma-9b", 3))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 3
#: kernels vs plain versions over two steps from one init: the losses'
#: relative difference (fp32 sums in other orders, as phase 5); each
#: gradient's normwise difference at step 1 (the worst reading was 2.1e-5,
#: on Mamba2's A_log; tests/test_torch_gpu.py holds one kernel's
#: gradients to 1e-4 too); each parameter's after step 2; and AdamW's m
#: and v after step 2, linear and quadratic in the two steps' gradients,
#: hence twice the gradients' limit.  The leaves that start at zero
#: (biases, conv_b, A_log, dt_bias) are then the AdamW updates alone, which
#: normalize each element by its own gradient, so an element whose
#: gradient is near zero moves by up to +-lr whatever its relative error:
#: m and v hold them, and their parameters' largest difference is printed
#: in units of step 2's lr
TRAIN_LOSS_RTOL, TRAIN_GRAD_NORMWISE, TRAIN_PARAM_NORMWISE = 1e-5, 1e-4, 1e-4
TRAIN_STATE_NORMWISE = 2e-4
#: the learning check: AdamW settings and steps on the learnable batch
LEARN = dict(lr=1e-3, warmup_steps=3, weight_decay=0.0)
LEARN_STEPS = 10
#: phase 7: the probe traces of ``repro/runtime/selftest.py``
#: (``elastic:trace/*``), 6 steps at 2 microbatches, with the transition
#: kinds the selftest expects
PROBE_TRACES = {
    "4to2": ([(0, (0, 1, 2, 3), "dp"), (2, (0, 1), "dp"), (4, (0, 1), "pp")],
             ["shrink", "class-change"]),
    "2to4": ([(0, (0, 1), "dp"), (2, (0, 1, 2, 3), "dp"),
              (4, (0, 1, 2, 3), "pp")], ["grow", "class-change"]),
    "hetero": ([(0, (0, 1, 2, 3), "dp"), (2, (0, 1, 2, 3), "hetero"),
                (4, (0, 1), "dp")], ["class-change", "shrink"]),
}
#: ... and phase 5's program through the driver: dp2 x tp2 on devices 0-3,
#: tp2 on devices 0-1 from step 1 (a shrink), dp2 x tp2 again from step 2
ELASTIC_TRACE = [(0, (0, 1, 2, 3)), (1, (0, 1)), (2, (0, 1, 2, 3))]
#: phase 9: the families of the port's last model slice, each at published
#: widths, fp32, random weights from seed 0, batch 4: (arch, layers or None
#: for full depth, prompt length).  DeepSeek-V2 keeps its dense layer 0 and
#: one MoE layer, Grok-1 one MoE layer (phase 12's depths: a second MoE
#: layer repeats the first's code path for ~8 s of cache fill), Qwen2-VL
#: two layers; Whisper 8 of its 32 encoder and 8 of its 32 decoder layers
#: (``launch.train.cut_depth``: the decoder's depth is its cache fill's
#: host time, the encoder's most of its training step), its prompt inside
#: the 448 positions of its decoder
FAMILIES = (("deepseek-v2-236b", 2, 512), ("grok-1-314b", 1, 512),
            ("qwen2-vl-72b", 2, 512), ("whisper-large-v3", 8, 384))
#: the largest share of prefill tokens whose MoE routing (an expert of the
#: top-k, or whether capacity keeps it) may differ between the kernels and
#: the plain versions: they differ by ~1e-6, which flips a near-tie
ROUTING_FLIP_MAX = 0.01
#: phase 12: phase 9's families trained through ``launch.train.main`` at
#: published widths (phase 6's batch, microbatches, remat, AdamW fp32):
#: (arch, layers or None for full depth, routed experts or None for the
#: published count, sequence).  fp32 params, gradients, m and v take 16 B
#: a parameter, so one MoE layer at its published expert count does not
#: fit one 80 GB card for training: DeepSeek-V2 keeps its dense layer 0 and
#: one MoE layer of 64 of its 160 routed experts, Grok-1 one layer of 4 of
#: its 8; top-k, d_expert and the shared experts are kept.  Whisper keeps
#: phase 9's depth (``--layers`` cuts both stacks) at its 384 positions
FAMILY_TRAIN = (("deepseek-v2-236b", 2, 64, 512), ("grok-1-314b", 1, 4, 512),
                ("qwen2-vl-72b", 2, None, 512),
                ("whisper-large-v3", 8, None, 384))
#: kernels vs plain versions over two steps where tokens of a step route
#: differently (at most ROUTING_FLIP_MAX of them): a flipped token moves to
#: another expert wholesale, so the loss and the normwise differences of
#: the gradients, m and v (the routed experts' stacked weights the most)
#: are held to these limits in place of phase 6's, from that step on
FLIP_LOSS_RTOL, FLIP_NORMWISE = 1e-3, 1e-1
#: phase 10: ranks sharing the card over gloo: the world sizes of the rank
#: selftest and its case groups at each, then phase 5's program on
#: DIST_RANKS ranks for DIST_STEPS steps under (b) dp2 x tp2 and (c) the
#: hsize=2 dp2|tp2 strategy, each rank's B1 launches a step (one a layer),
#: then (d) phase 5's blocks under tp2 x pp2 for one step of DIST_PP_MICRO
#: microbatches, and the ranks' time limits (s).  (b) and (c) take 1 of
#: phase 5's 3 steps: a rank step takes 20-32 s of host staging and gloo
#: exchanges, and at 2 steps a whole run of this script (from a
#: ``git archive``, on an H100 80GB HBM3 at 700 W) took 1077-1081 s, too
#: near the 1200 s limit
DIST_SWEEP = {2: "comm,async", 4: "comm,api,async,search"}
#: phase 10 (e): one DeepSeek-V2 MoE layer at published widths (160 routed
#: experts top-6 at capacity factor 1.25, 2 shared, d_expert 1536), fp32,
#: EP_TOKENS tokens, expert-parallel over a (data, model) = EP_MESH mesh of
#: the launch's ranks, against rank 0's single-process capacity dispatch:
#: y normwise and aux relative limits (routing is held bitwise)
EP_ARCH, EP_TOKENS, EP_MESH = "deepseek-v2-236b", 4096, (1, 4)
EP_Y_NORMWISE, EP_AUX_REL = 1e-5, 1e-6
#: phase 11: the production dry run in CPU children started after phase 5:
#: the full dry runs (16 x 16, train_4k) and the anchor, phase 6's Qwen2-1.5B
#: run (TRAIN_ARCHS[0], fp32, plain versions) on a 1 x 1 mesh, whose
#: predicted peak must lie within ANCHOR_RTOL of phase 6's measured peak;
#: the child's threads
DRYRUN_FULL = (("qwen2-1.5b", "train_4k"), ("deepseek-v2-236b", "train_4k"))
ANCHOR_RTOL = 0.20
DRYRUN_THREADS = 1
DIST_RANKS, DIST_STEPS, DIST_PP_MICRO = 4, 1, 2
DIST_SWEEP_TIMEOUT, DIST_RUN_TIMEOUT = 180, 660


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) for each
    kernel in an ``nvcc -Xptxas=-v`` log, in order."""
    import re
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), *spill))
            fn, spill = None, (0, 0)
    return out


def eager_ms(fn, iters=20, warmup=3) -> float:
    """Time of one call of fn issued from Python, back to back: CUDA events
    around ``iters`` calls.  Where the host takes longer to issue a call
    than the card to run it, this is the host's time."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


_capture_stream = None


def time_ms(fn, iters=20, warmup=3, replays=3) -> float:
    """Device time of one call of fn: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost of issuing each call is left out.  Warm-up and capture share one
    side stream for the whole run (cuBLAS keeps a workspace per stream)."""
    import torch
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    side = _capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (iters * replays)


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The larger of operations over the peak rate of ``dtype`` and bytes
    over the memory rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bound_ms(q, k, causal, window, v=None) -> tuple[float, str]:
    """Least time on the card: the visible (q, k) pairs' 2 * D flops of
    Q K^T and 2 * Dv of P V (D = Dv unless ``v`` has its own head dim, as
    MLA's) at the peak rate of the inputs' type, against q, k, v and o
    moved once."""
    import torch
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dv = d if v is None else v.shape[-1]
    qi = torch.arange(sq)[:, None]
    ki = torch.arange(sk)[None, :]
    vis = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        vis &= ki <= qi
    if window is not None:
        vis &= ki > qi - window
    flops = 2.0 * b * h * (d + dv) * int(vis.sum())
    v_numel = k.numel() if v is None else v.numel()
    nbytes = q.element_size() * (q.numel() + k.numel() + v_numel
                                 + b * h * sq * dv)
    return bound(flops, nbytes, str(q.dtype).removeprefix("torch."))


def ssd_bound_ms(b, s, h, p, n, chunk, dtype, es,
                 kernel_only=False) -> tuple[float, str]:
    """The chunked scan's least work: per (b, chunk) C B^T on the causal
    half once (it is the same for every head), per (b, h, chunk) the masked
    product with xbar on the causal half, C S^T and the state update, 2
    flops a multiply-add.  Bytes: the function's inputs read once (x, B, C
    in ``dtype``; dt, A fp32) and y and the fp32 state written once; for
    the kernel alone la (fp32) and xbar stand for dt, A and x."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * b * nc * tri * n + 2.0 * b * h * nc * (
        tri * p + 2 * chunk * n * p)
    nbytes = es * (2 * b * s * h * p + 2 * b * s * n) + 4 * (
        b * s * h + b * h * p * n + (0 if kernel_only else h))
    return bound(flops, nbytes, dtype)


def rglru_bound_ms(b, s, w, dtype, es):
    """Bytes: the function reads x, r, i (in ``dtype``) and lam and writes
    y.  Its flops (a dozen elementwise ones per element) weigh nothing
    beside."""
    return bound(12.0 * b * s * w, es * 4 * b * s * w + 4 * w, dtype)


def attention_cases():
    """(name, dtype, B, H, K, Sq, Sk, D, causal, window, layout); D is one
    head dim, or (D of q and k, Dv of v) for MLA; names starting with
    "main" are timed."""
    return [
        ("main fp32", "float32", 4, 12, 2, 512, 512, 128, True, None, "bshd"),
        ("main bf16", "bfloat16", 4, 12, 2, 512, 512, 128, True, None,
         "bshd"),
        ("head dim 64", "float32", 2, 4, 2, 512, 512, 64, True, None, "bhsd"),
        ("GQA 1", "float32", 2, 4, 4, 384, 384, 128, True, None, "bhsd"),
        ("window 128", "float32", 2, 12, 2, 512, 512, 128, True, 128, "bhsd"),
        ("Sq != Sk, ragged", "float32", 1, 4, 2, 320, 200, 64, True, None,
         "bhsd"),
        ("Sq < Sk, non-causal", "bfloat16", 1, 6, 2, 100, 300, 64, False,
         None, "bhsd"),
        ("fully-masked rows", "float32", 1, 2, 1, 256, 128, 64, True, 16,
         "bhsd"),
        ("main D256 fp32", "float32", 4, 16, 1, 512, 512, 256, True, 2048,
         "bshd"),
        # Whisper large-v3's decoder self-attention at phase 9's prefill
        ("main D64 fp32", "float32", 4, 20, 20, 384, 384, 64, True, None,
         "bshd"),
        ("main D64 bf16", "bfloat16", 4, 20, 20, 384, 384, 64, True, None,
         "bshd"),
        ("main D256 bf16", "bfloat16", 4, 16, 1, 512, 512, 256, True, 2048,
         "bshd"),
        ("D256 window 128", "float32", 1, 4, 1, 640, 640, 256, True, 128,
         "bshd"),
        # the tensor-core path: each head dim with fully-masked rows, a
        # ragged Sq != Sk, non-causal, and a window that bites at D = 256
        ("fully-masked rows D64", "bfloat16", 1, 2, 1, 256, 128, 64, True,
         16, "bhsd"),
        ("fully-masked rows D128", "bfloat16", 1, 2, 1, 256, 128, 128, True,
         16, "bhsd"),
        ("fully-masked rows D256", "bfloat16", 1, 2, 1, 256, 128, 256, True,
         16, "bhsd"),
        ("Sq != Sk, ragged D128", "bfloat16", 1, 4, 2, 320, 200, 128, True,
         None, "bhsd"),
        ("non-causal D256", "bfloat16", 1, 4, 1, 200, 333, 256, False, None,
         "bshd"),
        ("D256 window 128 bf16", "bfloat16", 1, 4, 1, 640, 640, 256, True,
         128, "bshd"),
        # DeepSeek-V2's MLA prefill: q and k at 192, v at 128, 128 heads;
        # k and v are column views of one tensor, as the model splits them
        ("main MLA fp32", "float32", 4, 128, 128, 512, 512, (192, 128), True,
         None, "bshd"),
        ("main MLA bf16", "bfloat16", 4, 128, 128, 512, 512, (192, 128),
         True, None, "bshd"),
        ("MLA ragged", "float32", 1, 4, 2, 300, 200, (192, 128), True, None,
         "bshd"),
        ("MLA non-causal bf16", "bfloat16", 1, 4, 2, 300, 333, (192, 128),
         False, None, "bshd"),
        ("fully-masked rows MLA", "bfloat16", 1, 2, 1, 256, 128, (192, 128),
         True, 16, "bhsd"),
        # each branch of the MLA fp32 kernel (64 rows x 64 keys a tile) and
        # of the bf16 kernel at MLA's pair (128 rows x 64 keys on wgmma),
        # beside the cases above: Sq, Sk off the tiles, Sq < Sk and Sq > Sk,
        # no key for rows under a window, non-causal, and a grid smaller
        # than the card
        ("MLA ragged bf16", "bfloat16", 1, 4, 2, 300, 200, (192, 128), True,
         None, "bshd"),
        ("MLA non-causal", "float32", 1, 4, 2, 300, 333, (192, 128), False,
         None, "bshd"),
        *((f"MLA {what}{'' if dt == 'float32' else ' bf16'}", dt, *shape,
           (192, 128), True, None, "bshd")
          for dt in ("float32", "bfloat16")
          for what, shape in (("1/77", (1, 2, 2, 1, 77)),
                              ("Sq < Sk", (1, 4, 2, 100, 333)),
                              ("Sq > Sk", (1, 4, 2, 333, 100)),
                              ("B1 H2", (1, 2, 2, 512, 512)))),
        ("fully-masked rows MLA fp32", "float32", 1, 2, 1, 256, 128,
         (192, 128), True, 16, "bhsd"),
        # the bf16 kernel's branches at the other head dims: a grid smaller
        # than the card, Sq = 1 against Sk = 77, Sq < Sk and Sq > Sk
        # causal, q, k and v as column views of one (B, S, H, 3D) tensor (a
        # fused QKV projection's output), and a window that bites at 64 and
        # 128 (the main cases hold GQA 12/2, 16/1 and 20/20)
        *((f"{what} D{d} bf16", "bfloat16", *shape, d, True, None, layout)
          for d in (64, 128, 256)
          for what, shape, layout in (
              ("B1 H2", (1, 2, 2, 512, 512), "bshd"),
              ("1/77", (1, 2, 2, 1, 77), "bshd"),
              ("Sq < Sk", (1, 4, 2, 100, 333), "bshd"),
              ("Sq > Sk", (1, 4, 2, 333, 100), "bshd"),
              ("fused qkv", (2, 6, 6, 300, 300), "fused"))),
        ("window 128 D64 bf16", "bfloat16", 1, 4, 2, 640, 640, 64, True,
         128, "bshd"),
        ("window 128 D128 bf16", "bfloat16", 1, 4, 2, 640, 640, 128, True,
         128, "bshd"),
    ]


def ssd_cases():
    """(name, dtype, b, s, h, p, n, chunk); x, B and C are contiguous,
    except in the "column views" cases, where they are slices of one
    (b, s, h p + 2 n) tensor, as the model passes them.  The bf16 cases after the fp32 ones
    hold the bf16 design (tensor cores) at the fp32 cases' shapes, and at a
    ragged chunk of 100 rows (64 + 36) with p 32 and n 64."""
    return [
        ("main fp32", "float32", 4, 512, 32, 64, 128, 256),
        ("main bf16", "bfloat16", 4, 512, 32, 64, 128, 256),
        ("3 chunks, small p n", "float32", 1, 192, 2, 32, 64, 64),
        ("b 3, h 5", "float32", 3, 256, 5, 64, 128, 128),
        ("p 128, chunk 96", "bfloat16", 2, 192, 3, 128, 96, 96),
        ("s 1024, 4 chunks", "float32", 2, 1024, 8, 64, 128, 256),
        ("one chunk of 2048", "float32", 1, 2048, 4, 64, 128, 2048),
        ("h 5 bf16", "bfloat16", 2, 256, 5, 64, 128, 128),
        ("B, C column views", "float32", 2, 512, 32, 64, 128, 256),
        ("3 chunks, small p n", "bfloat16", 1, 192, 2, 32, 64, 64),
        ("s 1024, 4 chunks", "bfloat16", 2, 1024, 8, 64, 128, 256),
        ("one chunk of 2048", "bfloat16", 1, 2048, 4, 64, 128, 2048),
        ("B, C column views", "bfloat16", 2, 512, 32, 64, 128, 256),
        ("ragged chunk 100, p 32", "bfloat16", 2, 300, 4, 32, 64, 100),
    ]


def rglru_cases():
    """(name, dtype, b, s, w, lam); lam None draws lam ~ N(0, 0.5)."""
    return [
        ("main fp32", "float32", 4, 512, 4096, None),
        ("main bf16", "bfloat16", 4, 512, 4096, None),
        ("ragged w", "float32", 2, 300, 1000, None),
        # softplus(-9) ~ 1.2e-4, so a ~ 0.999: the carry runs the whole way
        ("long s, a near 1", "float32", 1, 2048, 256, -9.0),
        # odd w: the bf16 kernel loads its two channels one by one
        ("odd w, short s", "bfloat16", 3, 37, 1001, None),
        ("ragged w, s 300", "bfloat16", 2, 300, 1000, None),
        ("s 1", "float32", 2, 1, 4096, None),
        ("s 1", "bfloat16", 2, 1, 4096, None),
        # 700 = 2 x 256 + 188: a ragged last super-chunk of the fp32 kernel
        ("s 700", "float32", 2, 700, 512, None),
        # softplus(-20) ~ 2e-9: a and exp(2 log_a) round to 1.0 where r is
        # below ~0.9, so 1 - exp(2 log_a) = 0 and the 1e-12 clamp bites
        ("lam -20, a = 1", "float32", 2, 512, 256, -20.0),
    ]


def make_inputs(gen, dtype, b, h, kh, sq, sk, d, layout):
    """q, k, v on the card; ``"bshd"`` gives the transposed views the model
    hands the kernel, ``"bhsd"`` contiguous tensors, ``"fused"`` the
    transposed column views of one (B, S, H, 3D) tensor (needs h == kh and
    sq == sk).  With ``d`` a pair (D, Dv), k and v are the column views of
    one (.., D + Dv) tensor."""
    import torch
    d, dv = d if isinstance(d, tuple) else (d, None)
    if layout == "fused":
        qkv = torch.randn((b, sq, h, 3 * d), generator=gen,
                          device="cuda").to(dtype)
        return tuple(qkv[..., i * d:(i + 1) * d].transpose(1, 2)
                     for i in range(3))

    def one(n, s, width):
        shape = (b, s, n, width) if layout == "bshd" else (b, n, s, width)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if layout == "bshd" else x
    if dv is None:
        return one(h, sq, d), one(kh, sk, d), one(kh, sk, d)
    kv = one(kh, sk, d + dv)
    return one(h, sq, d), kv[..., :d], kv[..., d:]


def phase_attention(torch, fa, ref, gen):
    worst, timing = 0.0, {}
    for (name, dt, b, h, kh, sq, sk, d, causal, window,
         layout) in attention_cases():
        dtype = getattr(torch, dt)
        q, k, v = make_inputs(gen, dtype, b, h, kh, sq, sk, d, layout)
        d, dv = d if isinstance(d, tuple) else (d, d)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        torch.cuda.synchronize()
        if out.shape != (b, h, sq, dv) or out.dtype != dtype:
            fail(f"flash {name}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"flash {name}: non-finite output")
        err = (out.float() - want).abs().max().item()
        if dt == "bfloat16":
            # the schedule decides which block takes a row, never its
            # arithmetic: a second launch gives the same bits
            again = fa.flash_attention(q, k, v, causal=causal, window=window)
            if not torch.equal(out, again):
                fail(f"flash {name}: two launches on the same inputs differ")
        if name.startswith("fully-masked rows"):
            # rows 143.. see no key: the mean of v over all keys
            mean_err = (out[0, :, 255].float()
                        - v[0, 0].float().mean(0)).abs().max().item()
            err = max(err, mean_err)
        ok = err <= TOL[dt]
        print(f"  flash {name:20s} {dt:8s} B={b} H={h} K={kh} Sq={sq} "
              f"Sk={sk} D={d}{'' if dv == d else f'/{dv}'} causal={causal} "
              f"window={window} {layout}: "
              f"max|err| {err:.3e} (tol {TOL[dt]:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash {name}: max |err| {err} > {TOL[dt]}")
        worst = max(worst, err)
        if name.startswith("main"):
            sdpa = torch.nn.functional.scaled_dot_product_attention
            call = lambda: fa.flash_attention(q, k, v,  # noqa: E731
                                              causal=causal, window=window)
            per_call = cuda_kernels_per_call(torch, call)
            if per_call != 1:
                fail(f"flash {name}: {per_call} CUDA kernels a call, not 1")
            ms, host_ms = time_ms(call), eager_ms(call)
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window))
            # the window (2048) never bites at S = 512, so is_causal is the
            # same function
            lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True))
            bnd, by = attention_bound_ms(q, k, causal, window, v)
            timing[(d, dt)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bnd,
                                   bound_by=by, sdpa_ratio=ms / lib_ms,
                                   max_abs_err=err, eager_ms=host_ms,
                                   cuda_launches_per_call=per_call)
            print(f"    time: kernel {ms:.4f} ms, one CUDA kernel a call "
                  f"(issued from Python one by "
                  f"one {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms (kernel / sdpa {ms / lib_ms:.2f}), "
                  f"bound {bnd:.4f} ms ({by}); kernel at {bnd / ms:.1%} of "
                  f"the bound")
    # a head-dim pair the kernel is not built for raises on the card
    q = torch.zeros((1, 2, 128, 192), device="cuda")
    try:
        fa.flash_attention(q, q, q)
    except ValueError as exc:
        print(f"  flash q/k/v at 192/192: raises ({exc})")
    else:
        fail("flash: a call at head dims 192/192 did not raise")
    return worst, timing


def _close(out, want, atol, rtol):
    """max |out - want| and whether every element is within
    atol + rtol |want|."""
    diff = (out.float() - want).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.abs()).all())


def phase_ssd(torch, sk, ref, gen, ptxas=()):
    """Every SSD case against the plain version; the main ones timed.
    ``ptxas``: phase 2's (kernel, registers, spill stores, spill loads) of
    ``ssd_scan.cu``, printed beside the times."""
    F = torch.nn.functional
    worst, worst_bf16, timing = 0.0, 0.0, {}
    for fn, regs, st, ld in ptxas:
        print(f"  ssd kernel {fn}: {regs} registers, spills {st} / {ld} B")
    for name, dt, b, s, h, p, n, chunk in ssd_cases():
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        if name == "B, C column views":
            # x, B and C as the model splits its convolution output
            # (b, s, h p + 2 n): x's rows are h p + 2 n apart
            xbc = rnd(b, s, h * p + 2 * n)
            xbc[..., :h * p] *= 0.5
            xbc[..., h * p:] *= 0.3
            xbc = xbc.to(dtype)
            x = xbc[..., :h * p].unflatten(-1, (h, p))
            B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        else:
            x = (rnd(b, s, h, p) * 0.5).to(dtype)
        dts = F.softplus(rnd(b, s, h))
        A = -torch.exp(rnd(h) * 0.3)
        if name == "B, C column views":
            prep = sk.prepare(x, dts, A, B, C)
            if prep.B.data_ptr() != B.data_ptr() or (
                    dtype == torch.bfloat16
                    and prep.x.data_ptr() != x.data_ptr()):
                fail(f"ssd {name}: prepare() copied the column views")
        else:
            B = (rnd(b, s, n) * 0.3).to(dtype)
            C = (rnd(b, s, n) * 0.3).to(dtype)
        y, st = sk.ssd_scan(x, dts, A, B, C, chunk=chunk)
        yr, sr = ref.ssd_scan_ref(x.float(), dts, A, B.float(), C.float(),
                                  chunk)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != dtype or st.shape != (
                b, h, p, n) or st.dtype != torch.float32:
            fail(f"ssd {name}: outputs {tuple(y.shape)} {y.dtype}, "
                 f"{tuple(st.shape)} {st.dtype}")
        if not (bool(torch.isfinite(y).all()) and bool(
                torch.isfinite(st).all())):
            fail(f"ssd {name}: non-finite output")
        atol, rtol = SSD_TOL[dt]
        ey, oky = _close(y, yr, atol, rtol)
        es_, oks = _close(st, sr, atol, rtol)
        print(f"  ssd {name:20s} {dt:8s} b={b} s={s} h={h} p={p} n={n} "
              f"chunk={chunk}: max|err| y {ey:.3e}, state {es_:.3e} "
              f"(atol {atol:.0e}, rtol {rtol:.0e}) "
              f"{'ok' if oky and oks else 'FAIL'}")
        if not (oky and oks):
            fail(f"ssd {name}: y err {ey}, state err {es_}")
        worst = max(worst, ey, es_)
        if dtype == torch.bfloat16:
            worst_bf16 = max(worst_bf16, ey, es_)
        if name.startswith("main"):
            prep = sk.prepare(x, dts, A, B, C)
            call = lambda: sk.ssd_scan(x, dts, A, B, C,  # noqa: E731
                                       chunk=chunk)
            alone = lambda: sk.launch(prep, chunk=chunk)  # noqa: E731
            per_call = cuda_kernels_per_call(torch, alone)
            if per_call != SSD_CUDA_LAUNCHES[dt]:
                fail(f"ssd {name}: the kernel alone ran {per_call} CUDA "
                     f"kernels a call, not {SSD_CUDA_LAUNCHES[dt]}")
            wrapper_kernels = cuda_kernels_per_call(torch, call)
            ms, host_ms = time_ms(call), eager_ms(call)
            kms = time_ms(alone)
            plain_ms = time_ms(lambda: ref.ssd_scan_ref(x, dts, A, B, C,
                                                        chunk), iters=5)
            es = x.element_size()
            bnd, by = ssd_bound_ms(b, s, h, p, n, chunk, dt, es)
            kbnd, kby = ssd_bound_ms(b, s, h, p, n, chunk, dt, es, True)
            timing[dt] = dict(ms=ms, kernel_ms=kms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=bnd, bound_by=by,
                              kernel_bound_ms=kbnd, max_abs_err=max(ey, es_),
                              eager_ms=host_ms,
                              cuda_launches_per_call=per_call)
            print(f"    time: wrapper {ms:.4f} ms (kernel alone {kms:.4f} "
                  f"ms; wrapper issued from Python one by one {host_ms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms, no library call; bound "
                  f"{bnd:.4f} ms ({by}), kernel alone {kbnd:.4f} ms ({kby});"
                  f" wrapper at {bnd / ms:.1%} of the bound; CUDA "
                  f"kernels a call: {per_call:g} of the kernel alone, "
                  f"{wrapper_kernels:g} of the wrapper")
    print(f"  ssd bf16 (tensor cores): worst |err| {worst_bf16:.3e} over "
          f"{sum(c[1] == 'bfloat16' for c in ssd_cases())} cases")
    timing["bfloat16"]["worst_case_err"] = worst_bf16
    return worst, timing


def cuda_kernels_per_call(torch, fn, calls=3, windows=3) -> float:
    """CUDA kernels that ``torch.profiler`` sees run, per call of fn: the
    most over ``windows`` profiled windows of ``calls`` calls.  The
    profiler can lose a kernel's record (a window once read 2 kernels in 3
    calls of the one-kernel RG-LRU wrapper on the H100) and never adds
    one, so the most is the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    most = 0.0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA) / calls)
    return most


def phase_rglru(torch, rk, ref, gen):
    worst, timing = 0.0, {}
    for name, dt, b, s, w, lam_v in rglru_cases():
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (rnd(b, s, w) * 0.5).to(dtype)
        r = torch.sigmoid(rnd(b, s, w)).to(dtype)
        i = torch.sigmoid(rnd(b, s, w)).to(dtype)
        lam = rnd(w) * 0.5 if lam_v is None else torch.full(
            (w,), lam_v, device="cuda")
        before = rk.launches
        y = rk.rglru_scan(x, r, i, lam)
        counted = rk.launches - before
        yr = ref.rglru_ref(x.float(), r.float(), i.float(), lam)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != dtype or counted != 1:
            fail(f"rglru {name}: output {tuple(y.shape)} {y.dtype}, "
                 f"{counted} launches counted")
        if not bool(torch.isfinite(y).all()):
            fail(f"rglru {name}: non-finite output")
        atol, rtol = RGLRU_TOL[dt]
        err, ok = _close(y, yr, atol, rtol)
        extra = ""
        if dtype == torch.bfloat16:
            # the plain version on the same bf16 inputs rounds i x to bf16
            yb = ref.rglru_ref(x, r, i, lam)
            errb, okb = _close(y, yb.float(), atol, rtol)
            share = (y != yb).float().mean().item()
            ok = ok and okb and share <= RGLRU_BF16_MISMATCH
            extra = (f"; vs plain on bf16 inputs {errb:.3e}, {share:.4%} of "
                     f"outputs differ (at most {RGLRU_BF16_MISMATCH:.0%})")
            err = max(err, errb)
        print(f"  rglru {name:18s} {dt:8s} b={b} s={s} w={w} lam="
              f"{'N(0,0.5)' if lam_v is None else lam_v}: max|err| "
              f"{err:.3e} (atol {atol:.0e}, rtol {rtol:.0e}){extra} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"rglru {name}: max |err| {err}{extra}")
        worst = max(worst, err)
        if name.startswith("main"):
            call = lambda: rk.rglru_scan(x, r, i, lam)  # noqa: E731
            per_call = cuda_kernels_per_call(torch, call)
            if per_call != 1:
                fail(f"rglru {name}: {per_call} CUDA kernels a call, not 1")
            ms, host_ms = time_ms(call), eager_ms(call)
            plain_ms = time_ms(lambda: ref.rglru_ref(x, r, i, lam), iters=5)
            bnd, by = rglru_bound_ms(b, s, w, dt, x.element_size())
            timing[dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              bound_ms=bnd, bound_by=by, max_abs_err=err,
                              eager_ms=host_ms,
                              cuda_launches_per_call=per_call)
            print(f"    time: wrapper {ms:.4f} ms, one CUDA kernel a call "
                  f"(issued from Python one by one {host_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, no library call; bound {bnd:.4f} ms "
                  f"({by}); wrapper at {bnd / ms:.1%} of the bound")
    return worst, timing


def expected_prefill_launches(cfg) -> dict[str, int]:
    """One launch per layer that holds the kernel: every self-attention
    of the decoder stack (at prompt lengths that are multiples of 128, as
    the JAX gate asks; Whisper's encoder over 1500 frames and its
    cross-attention take the plain path)."""
    from repro_torch.models.model import griffin_pattern, layer_groups
    want = {"flash": 0, "ssd": 0, "rglru": 0}
    for kind, count in layer_groups(cfg):
        if kind in ("dense", "moe", "dec"):
            want["flash"] += count
        elif kind == "mamba":
            want["ssd"] += count
        else:
            for sub in griffin_pattern(cfg, kind):
                want["rglru" if sub == "rec" else "flash"] += count
    return want


def phase_serve(torch, policy, arch):
    print(f"== phase 4: serve {arch} full width, full depth")
    import numpy as np

    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.steps import build_prefill_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params fp32 ({weights / 1e9:.2f} GB), "
          f"init {time.perf_counter() - t0:.1f} s, init peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (BATCH, PROMPT))).to("cuda")

    policy.set_policy("auto")
    # a warm-up prefill: the timed one then excludes cuBLAS's first-call setup
    build_prefill_step(cfg)(params, {"tokens": prompts})
    for mod in serve.KERNELS.values():
        mod.launches = 0
    res = serve.generate(params, cfg, {"tokens": prompts}, GEN)
    launches = serve.launch_counts()

    print(f"  prefill {BATCH}x{PROMPT}: {res['prefill_ms']:.2f} ms; cache "
          f"fill ({PROMPT} decode steps) {res['fill_ms']:.1f} ms; decode "
          f"{GEN - 1} steps {res['decode_ms']:.1f} ms = "
          f"{res['decode_tok_s']:.1f} tok/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = expected_prefill_launches(cfg)
    print(f"  kernel launches: prefill {res['prefill_launches']}, whole run "
          f"{launches} (expected {want} in prefill, none in decode)")
    print(f"  prefill vs teacher-forced logits: max |diff| "
          f"{res['max_abs_diff']:.3e} (atol 2e-3, rtol 1e-3, same argmax): "
          f"{'ok' if res['agree'] else 'FAIL'}")
    print("  sample (token ids):", res["tokens"][0, :16].tolist())
    if res["prefill_launches"] != want or launches != want:
        fail(f"{arch}: expected {want} launches in prefill and none in "
             f"decode; prefill {res['prefill_launches']}, whole run "
             f"{launches}")
    if not res["agree"]:
        fail(f"{arch}: prefill and teacher-forced decode logits disagree")
    for key in ("prefill_logits", "teacher_logits"):
        if res[key].shape != (BATCH, cfg.vocab) or not bool(
                torch.isfinite(res[key]).all()):
            fail(f"{arch} {key}: shape {tuple(res[key].shape)} or "
                 f"non-finite")
    if tuple(res["tokens"].shape) != (BATCH, GEN):
        fail(f"{arch}: tokens shape {tuple(res['tokens'].shape)}")

    # the same prefill through the plain versions on the card
    policy.set_policy("ref")
    try:
        plain = build_prefill_step(cfg)(params, {"tokens": prompts})
    finally:
        policy.set_policy("auto")
    diff = (plain - res["prefill_logits"]).abs().max().item()
    same = bool(torch.allclose(plain, res["prefill_logits"], atol=2e-3,
                               rtol=1e-3)) and bool(
        (plain.argmax(-1) == res["prefill_logits"].argmax(-1)).all())
    print(f"  prefill, kernels vs plain versions: max |diff| {diff:.3e}: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail(f"{arch}: prefill through the kernels disagrees with the "
             f"plain path")
    where_the_time_goes(torch, cfg, params, {"tokens": prompts})
    fp32_logits = res["prefill_logits"]
    del res, plain
    bf16 = phase_serve_bf16(torch, policy, cfg, params, prompts, fp32_logits)
    del params
    torch.cuda.empty_cache()
    return launches, bf16


def phase_serve_bf16(torch, policy, cfg, params, prompts, fp32_logits):
    """The same prompts prefilled in bf16 through ``build_prefill_step``, on
    phase 4's weights cast to bf16 under the JAX package's rule (``A_log``,
    ``dt_bias`` and ``lam`` stay fp32): every kernel once per layer that
    holds it, none plain, no farther from the fp32 prefill than the same
    bf16 prefill through the plain versions is (gated, by
    ``BF16_VS_FP32_RATIO``) and against that plain prefill (recorded); its
    time, peak memory, device busy share and the SSD scan's share of it."""
    from repro_torch import serve
    from repro_torch.convert import FP32_LEAVES, cast_params
    from repro_torch.train.steps import build_prefill_step
    from repro_torch.tree import paths

    print(f"== phase 4 bf16: prefill {cfg.name} in bf16, {BATCH}x{PROMPT}")
    pb = cast_params(params, torch.bfloat16)
    wrong = [path for path, leaf in paths(pb) if leaf.dtype != (
        torch.float32 if path[-1] in FP32_LEAVES else torch.bfloat16)]
    if wrong:
        fail(f"{cfg.name} bf16: leaves off the fp32-leaf rule: {wrong}")
    kept = sorted({path[-1] for path, leaf in paths(pb)
                   if leaf.dtype == torch.float32})
    prefill, batch = build_prefill_step(cfg), {"tokens": prompts}
    policy.set_policy("auto")
    prefill(pb, batch)  # warm-up: cuBLAS's bf16 set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    for mod in serve.KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    logits = prefill(pb, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_prefill_launches(cfg)
    print(f"  prefill {ms:.2f} ms, peak memory {peak:.2f} GiB, of which "
          f"{peak - resident:.2f} GiB above the resident fp32 weights and "
          f"their bf16 copy; kernel launches {launches} (expected {want}); "
          f"fp32 leaves kept: {kept}")
    if launches != want:
        fail(f"{cfg.name} bf16: expected {want} launches in prefill, got "
             f"{launches}")
    if logits.shape != (BATCH, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{cfg.name} bf16: logits {tuple(logits.shape)} or non-finite")

    policy.set_policy("ref")
    try:
        plain = prefill(pb, batch)
    finally:
        policy.set_policy("auto")

    def compare(got, want):
        a, b = got.float(), want.float()
        return {"normwise": normwise(a, b),
                "max_abs_diff": (a - b).abs().max().item(),
                "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float()
                .mean().item()}
    vs_plain, vs_fp32 = compare(logits, plain), compare(logits, fp32_logits)
    plain_vs_fp32 = compare(plain, fp32_logits)
    limit = BF16_VS_FP32_RATIO * plain_vs_fp32["normwise"]
    ok = vs_fp32["normwise"] <= limit
    for what, d in (("kernels", vs_fp32), ("plain versions", plain_vs_fp32)):
        print(f"  bf16 through the {what} vs the fp32 prefill: normwise "
              f"{d['normwise']:.3e}, max |diff| {d['max_abs_diff']:.3e}, "
              f"argmax agrees on {d['argmax_agree']:.0%} of prompts")
    print(f"  kernels' distance from fp32 at most {BF16_VS_FP32_RATIO} x the "
          f"plain versions' = {limit:.3e}: "
          f"{vs_fp32['normwise'] / plain_vs_fp32['normwise']:.3f} x, "
          f"{'ok' if ok else 'FAIL'}; kernels vs plain versions (bf16, "
          f"recorded): normwise {vs_plain['normwise']:.3e}, max |diff| "
          f"{vs_plain['max_abs_diff']:.3e}, argmax agrees on "
          f"{vs_plain['argmax_agree']:.0%}")
    if not ok:
        fail(f"{cfg.name} bf16: prefill through the kernels lies farther "
             f"from the fp32 prefill than the plain bf16 path does")
    on_path = ssd_on_path(torch, lambda: prefill(pb, batch)) if want[
        "ssd"] else None
    wall, kernels = profiled(torch, lambda: prefill(pb, batch))
    busy = sum(k_ms for k_ms, _, _ in kernels)
    ssd_ms = sum(k_ms for k_ms, key, _ in kernels if "ssd_" in key)
    print(f"  where the time goes: host {wall:.3f} ms, device kernels "
          f"{busy:.3f} ms ({busy / wall:.1%} busy); SSD scan {ssd_ms:.3f} ms "
          f"({ssd_ms / busy:.1%} of device time)")
    for k_ms, key, count in kernels[:6]:
        print(f"    {k_ms:8.3f} ms  {count:4d}x  {key[:80]}")
    del pb, logits, plain
    return {"prefill_ms": ms, "peak_gib": peak,
            "prefill_gib": peak - resident, "launches": launches,
            "vs_plain": vs_plain, "vs_fp32": vs_fp32,
            "plain_vs_fp32": plain_vs_fp32, "limit": limit, "host_ms": wall,
            "device_ms": busy, "busy": busy / wall, "ssd_ms": ssd_ms,
            "ssd_share": ssd_ms / busy, "ssd_on_path": on_path}


def ssd_on_path(torch, run):
    """Every SSD kernel call of ``run`` (a bf16 prefill) held against the
    plain version on that call's own inputs: x, B and C as the model passes
    them (views of the convolution output), dt and A as the layer forms
    them.  Each y and state within phase 3's tolerance and within
    ``SSD_PATH_NORMWISE``: the last position's logits hardly see a fault in
    the state carried between chunks, and at the model's small y phase 3's
    atol would not either."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_ref
    kernel, (atol, rtol) = ops.ssd_scan_with_grad, SSD_TOL["bfloat16"]
    calls = []  # (y's max |err|, normwise, the state's, ok) a call

    def rel(a, b):
        return ((a.double() - b).norm() / b.double().norm()).item()

    def held(x, dt, A, B, C, *, chunk):
        y, st = kernel(x, dt, A, B, C, chunk=chunk)
        yr, sr = ssd_scan_ref(x.float(), dt, A, B.float(), C.float(), chunk)
        (ey, oky), (es, oks) = _close(y, yr, atol, rtol), _close(
            st, sr, atol, rtol)
        ny, ns = rel(y, yr), rel(st, sr)
        calls.append((ey, ny, es, ns, oky and oks and max(ny, ns)
                      <= SSD_PATH_NORMWISE))
        return y, st
    ops.ssd_scan_with_grad = held
    try:
        run()
    finally:
        ops.ssd_scan_with_grad = kernel
    bad = sum(not c[-1] for c in calls)
    ey, ny, es, ns = (max((c[k] for c in calls), default=0.0)
                      for k in range(4))
    print(f"  SSD on the prefill's own inputs: {len(calls)} calls, worst y "
          f"|err| {ey:.3e}, normwise {ny:.3e}; state {es:.3e}, {ns:.3e} "
          f"(atol {atol:.0e}, rtol {rtol:.0e}, normwise at most "
          f"{SSD_PATH_NORMWISE:.2e}): {f'{bad} FAIL' if bad else 'ok'}")
    if bad or not calls:
        fail(f"SSD on the prefill's own inputs: {bad} of {len(calls)} calls "
             f"off the plain version")
    return {"calls": len(calls), "max_abs_err_y": ey, "normwise_y": ny,
            "max_abs_err_state": es, "normwise_state": ns}


def where_the_time_goes(torch, cfg, params, prompt, steps=8):
    """Host time of one prefill and of ``steps`` decode steps, their summed
    device kernel time under ``torch.profiler`` (so the device's busy
    share), and the heaviest kernels.  Returns {"prefill", "decode step":
    {"host_ms", "device_ms", "busy"}}."""
    from repro_torch import serve
    from repro_torch.models.model import init_decode_state, run_encoder
    from repro_torch.train.steps import build_decode_step, build_prefill_step

    prefill, step = build_prefill_step(cfg), build_decode_step(cfg)
    b, p = prompt.get("tokens", prompt.get("embeds")).shape[:2]
    enc_out = None
    if cfg.encdec:
        with torch.inference_mode():
            enc_out = run_encoder(params, prompt, cfg)
    state = init_decode_state(cfg, b, p + GEN, device="cuda",
                              enc_out=enc_out)
    first = serve.decode_batch(cfg, prompt, 0)

    def run_prefill():
        prefill(params, prompt)

    def run_decode():
        for _ in range(steps):
            step(params, state, first)

    print(f"== where the time goes, {cfg.name} (host clock; device time "
          f"from torch.profiler)")
    out = {}
    for name, fn, n in (("prefill", run_prefill, 1),
                        ("decode step", run_decode, steps)):
        wall, kernels = profiled(torch, fn, n)
        busy = sum(ms for ms, _, _ in kernels)
        print(f"  {name}: host {wall:.3f} ms, device kernels {busy:.3f} ms "
              f"({busy / wall:.1%} busy), "
              f"{sum(k for _, _, k in kernels) // n} kernel launches")
        for ms, key, _ in kernels[:6]:
            print(f"    {ms:8.3f} ms  {key[:90]}")
        out[name] = {"host_ms": wall, "device_ms": busy, "busy": busy / wall}
    return out


def profiled(torch, fn, n=1):
    """Host ms of one unprofiled run of fn (after a warm one), synchronized,
    over ``n``; and fn's CUDA kernels under ``torch.profiler``, heaviest
    first, as (device ms over ``n``, name, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [((getattr(e, "self_device_time_total", None)
                 or e.self_cuda_time_total) / 1e3 / n, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return wall, sorted(kernels, reverse=True)


def block_weights(prog, rng):
    """Norm weights at one, the rest N(0, 0.05^2), drawn in parameter
    order, in fp32: a float64 draw and cast takes over twice as long,
    which phase 8's 1.5 B parameters and each rank of phase 10 feel."""
    import numpy as np

    def normal(shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(0.05)
        return w
    return {t.name: np.ones(t.shape, np.float32)
            if "norm" in t.name.split("/")[-1] else normal(t.shape)
            for t in prog.graph.parameters()}


def block_feeds(cfg, rng, batch, seq):
    import numpy as np
    return {"ids": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, seq))
            .astype(np.int32)}


def check_against_simulator(what, got, want_loss, want_grads):
    """Step 1's loss and every gradient against the simulator's: the
    elementwise tolerance of ``tests/test_archs.py`` and, since at full
    vocabulary the gradients are far below its atol, the normwise
    relative error ||got - want|| / ||want|| <= GRAD_NORM_RTOL as well,
    except for the key biases: their gradient is mathematically zero
    (softmax is shift-invariant along the keys), so both sides are
    rounding noise and only the elementwise tolerance applies."""
    import numpy as np
    lerr = abs(got.loss - want_loss) / abs(want_loss)
    worst, worst_name, bad = 0.0, None, []
    for name, want in want_grads.items():
        g = got.grad_value(name)
        if g.shape != want.shape or not np.isfinite(g).all():
            fail(f"{what}: grad {name} shape {g.shape} or non-finite")
        if not np.allclose(g, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
            bad.append(name)
        if name.endswith("/bk"):
            continue
        norm = float(np.linalg.norm(want.astype(np.float64)))
        rel = float(np.linalg.norm((g - want).astype(np.float64))) / norm \
            if norm else float(np.abs(g).max())
        if rel > worst:
            worst, worst_name = rel, name
    ok = lerr <= LOSS_RTOL and not bad and worst <= GRAD_NORM_RTOL
    print(f"  {what} vs SimulatorExecutor: loss {got.loss:.9e} vs "
          f"{want_loss:.9e} (rel {lerr:.2e}, rtol {LOSS_RTOL:.0e}); "
          f"{len(want_grads)} grads within atol {GRAD_ATOL:.0e} rtol "
          f"{GRAD_RTOL:.0e}: {'all' if not bad else bad}; worst normwise "
          f"relative error {worst:.2e} ({worst_name}; limit "
          f"{GRAD_NORM_RTOL:.0e}): {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: step 1 disagrees with the simulator")


def device_breakdown(prof):
    """Device time of the profiled window by kind: the flash kernel, the
    GEMMs, host<->device copies and the rest (elementwise, gathers,
    reductions); in ms, with the launch count and the six heaviest."""
    from torch.autograd import DeviceType
    parts = {"flash (B1)": 0.0, "GEMM": 0.0, "copy host<->device": 0.0,
             "other kernels": 0.0}
    launches, top = 0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or e.self_cuda_time_total) / 1e3
        key = e.key.lower()
        launches += e.count
        top.append((ms, e.key))
        if "flash_" in key:
            parts["flash (B1)"] += ms
        elif "gemm" in key or "cutlass" in key:
            parts["GEMM"] += ms
        elif "memcpy" in key and ("htod" in key or "dtoh" in key):
            parts["copy host<->device"] += ms
        else:
            parts["other kernels"] += ms
    return parts, launches, sorted(top, reverse=True)[:6]


def b1_at_shape(torch, fa, ref, shape, b, h, kh, seq, hd):
    """B1 at a graph-IR path's shape (q (b, h, seq, hd), k and v (b, kh,
    seq, hd), causal fp32): max |err| against its plain version, the
    kernel's, the plain version's and SDPA's device times, the bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, h, seq, hd), generator=gen, device="cuda")
    k = torch.randn((b, kh, seq, hd), generator=gen, device="cuda")
    v = torch.randn((b, kh, seq, hd), generator=gen, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True)
    err = (out - ref.flash_attention_ref(q, k, v, causal=True)).abs().max() \
        .item()
    if err > TOL["float32"]:
        fail(f"flash at {shape}: max |err| {err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    bnd, by = attention_bound_ms(q, k, True, None)
    print(f"  B1 at {shape}: max|err| {err:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bnd:.4f} ms "
          f"({by})")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bnd, bound_by=by, max_abs_err=err)


#: threads of the phase-5 reference's child process, which runs beside
#: phases 1 to 4 on the 8-core host
SIM_THREADS = 4


def simulator_reference_main(path) -> int:
    """Phase 5's reference in a child process: the port's
    ``SimulatorExecutor`` (numpy, on the host) takes step 1 of phase 5's
    program from seed 0; its loss and every gradient go to ``path``
    (``.npz``).  Touches no GPU."""
    import numpy as np

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.graph_block import block_program

    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    prog = block_program(cfg, batch=IR_BATCH, seq=IR_SEQ, n_layers=IR_LAYERS,
                         dp=2, tp=2, pp=1)
    rng = np.random.default_rng(0)
    feeds = block_feeds(cfg, rng, IR_BATCH, IR_SEQ)
    ws = block_weights(prog, rng)
    sim = api.Session(prog, 0, executor=api.SimulatorExecutor())
    sim.load(ws)
    want = sim.train_step(dict(feeds))
    np.savez(path, loss=np.float64(want.loss),
             seconds=np.float64(time.perf_counter() - t0),
             **{f"grad|{n}": want.grad_value(n) for n in ws})
    return 0


class SimulatorReference:
    """Phase 5's reference step (:func:`simulator_reference_main`) in a
    child process started first, so that its minutes of host numpy run
    beside phases 1 to 4; :meth:`result` waits for it.  The
    child is killed if the script ends first."""

    def __init__(self, out_dir):
        import atexit
        import os
        self.path = Path(out_dir) / "simulator_step1.npz"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS=str(SIM_THREADS),
                   OPENBLAS_NUM_THREADS=str(SIM_THREADS),
                   MKL_NUM_THREADS=str(SIM_THREADS))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.simulator_reference_main(sys.argv[1]))",
             str(self.path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self):
        """(loss, {name: gradient}, the child's seconds, seconds waited)."""
        import numpy as np
        t0 = time.perf_counter()
        out, _ = self.proc.communicate()
        waited = time.perf_counter() - t0
        if self.proc.returncode != 0:
            fail(f"phase 5's SimulatorExecutor reference exited with "
                 f"{self.proc.returncode}:\n{out[-3000:]}")
        with np.load(self.path) as z:
            grads = {k.split("|", 1)[1]: z[k] for k in z.files
                     if k.startswith("grad|")}
            loss, secs = float(z["loss"]), float(z["seconds"])
        self.path.unlink()
        return loss, grads, secs, waited


def phase_graph_ir(torch, fa, ref, sim_ref):
    """Graph-IR training on ``TorchExecutor``: full-width Qwen2-1.5B
    blocks under dp2 x tp2, step 1 against ``sim_ref`` (a
    :class:`SimulatorReference`), then reduced Llama under tp2 x pp2 with
    two microbatches.  Returns B1's launches on this path and its timings
    at the path's shape, and the Qwen2 run (config, feeds, initial
    weights, losses, final weights and AdamW m/v) for phase 7."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.graph_block import block_program

    cfg = get_config("qwen2-1.5b")
    print(f"== phase 5: graph-IR training, {cfg.name} full width "
          f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {IR_LAYERS} "
          f"layers, batch {IR_BATCH}, seq {IR_SEQ}, dp2 x tp2 on 4 virtual "
          f"devices stacked on the one GPU")
    prog = block_program(cfg, batch=IR_BATCH, seq=IR_SEQ, n_layers=IR_LAYERS,
                         dp=2, tp=2, pp=1)
    rng = np.random.default_rng(0)
    feeds = block_feeds(cfg, rng, IR_BATCH, IR_SEQ)
    ws = block_weights(prog, rng)
    print(f"  {sum(w.size for w in ws.values()) / 1e6:.1f} M parameters, "
          f"random from seed 0 (numpy)")

    # the reference: the port's SimulatorExecutor, in numpy on the host,
    # in the child process started after phase 2
    want_loss, want_grads, sim_s, waited = sim_ref.result()
    if set(want_grads) != set(ws):
        fail(f"phase 5's reference has gradients {sorted(want_grads)}")
    print(f"  SimulatorExecutor step 1 on the host (a child process with "
          f"{SIM_THREADS} threads beside phases 1-4): {sim_s:.1f} s, "
          f"waited for {waited:.1f} s here; loss {want_loss:.9e}")

    ex = api.TorchExecutor()
    sess = api.Session(prog, 0, executor=ex)
    sess.load(ws)
    tplan = prog.compile_train(0)
    fetch = [tplan.loss_name] + [tplan.grad_map[t.name]
                                 for t in tplan.graph.parameters()]
    stats = ex.lowered(tplan, fetch).stats
    classes = stats.kernel_dispatches
    print(f"  lowered: {stats.compute_segments} segments "
          f"({stats.straightline_segments} one class over every row), "
          f"{stats.stages} comm stages ({stats.uniform_reduce_stages} "
          f"whole-buffer reduces, {stats.uniform_copy_stages} whole-buffer "
          f"copies), attention classes: {classes} on B1, "
          f"{stats.ref_dispatches} on the plain version")
    if classes != IR_LAYERS or stats.ref_dispatches:
        fail(f"graph IR: expected {IR_LAYERS} attention classes on B1 "
             f"(one per layer), got {classes} and {stats.ref_dispatches} "
             f"plain")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step, opt_s = [], [], [], []
    at_dist = None
    fa.launches = 0
    try:
        for step in range(3):
            before = fa.launches
            ex.times.reset()
            profiled = step == 2
            ex.times.sync = profiled
            t0 = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    r = sess.train_step(dict(feeds))
                    torch.cuda.synchronize()
            else:
                r = sess.train_step(dict(feeds))
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append(fa.launches - before)
            opt_s.append(r.update_seconds)
            losses.append(r.loss)
            if step == 0:
                check_against_simulator("Qwen2-1.5B dp2 x tp2 step 1", r,
                                        want_loss, want_grads)
            if step + 1 == DIST_STEPS:
                # phase 10 holds its DIST_STEPS steps on ranks to this state
                at_dist = {key: {n: api.ShardedTensor(
                    st.shape, st.annot,
                    {d: np.array(p) for d, p in st.parts.items()})
                    for n, st in tree.items()} for key, tree in (
                        ("weights", sess.weights), ("m", sess.opt_state["m"]),
                        ("v", sess.opt_state["v"]))}
            parts = ex.times.as_dict()
            print(f"  step {step + 1}: loss {r.loss:.9e}, "
                  f"{walls[-1] * 1e3:.1f} ms{' (profiled)' if profiled else ''}"
                  f", grad norm {r.metrics['grad_norm']:.3e}, B1 launches "
                  f"{per_step[-1]} (the lowered graph dispatches "
                  f"{classes})")
    finally:
        ex.times.sync = False
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(p != classes for p in per_step):
        fail(f"graph IR: B1 launches per step {per_step}, expected "
             f"{classes} (layers x classes)")
    if not all(np.isfinite(losses)) or len(set(losses)) != len(losses):
        fail(f"graph IR: losses {losses} not finite or not changing")
    other = walls[2] - sum(parts[p] for p in ("pack", "compute", "comm",
                                              "fetch")) - opt_s[2]
    print(f"  step time (host clock, synchronized): step 1 "
          f"{walls[0] * 1e3:.1f} ms, step 2 {walls[1] * 1e3:.1f} ms; peak "
          f"memory {peak:.2f} GiB")
    print(f"  where step 3's {walls[2] * 1e3:.1f} ms go (host clock, device "
          f"synchronized at each boundary): pack numpy shards + copy to the "
          f"device {parts['pack'] * 1e3:.1f} ms; compute segments "
          f"{parts['compute'] * 1e3:.1f} ms (of which B1 "
          f"{parts['attention'] * 1e3:.2f} ms); comm row moves "
          f"{parts['comm'] * 1e3:.1f} ms; copy fetches to the host + unpack "
          f"{parts['fetch'] * 1e3:.1f} ms; host numpy AdamW "
          f"{opt_s[2] * 1e3:.1f} ms; the rest of the session "
          f"{other * 1e3:.1f} ms")
    dev, n_launch, top = device_breakdown(prof)
    busy = sum(dev.values())
    print(f"  step 3 on the device (torch.profiler): {busy:.1f} ms of "
          f"{walls[2] * 1e3:.1f} ms host ({busy / (walls[2] * 1e3):.1%} "
          f"busy), {n_launch} device activities: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in dev.items()))
    for ms_, key in top:
        print(f"    {ms_:9.3f} ms  {key[:90]}")
    print(f"  host numpy AdamW per step: "
          + ", ".join(f"{s * 1e3:.1f} ms" for s in opt_s))

    # B1 at this path's shape: the four device rows fold into the batch
    shape = (f"B{IR_BATCH // 2 * 4} H{cfg.n_heads // 2} K"
             f"{cfg.n_kv_heads // 2} S{IR_SEQ} D{cfg.hd} causal fp32 "
             f"(graph-IR Qwen2-1.5B dp2 x tp2: 4 device rows folded into the "
             f"batch)")
    timing = b1_at_shape(torch, fa, ref, shape, IR_BATCH // 2 * 4,
                         cfg.n_heads // 2, cfg.n_kv_heads // 2, IR_SEQ,
                         cfg.hd)
    print(f"    {IR_LAYERS} launches a step = {IR_LAYERS * timing['ms']:.3f} "
          f"ms of the step")
    timing["launches"] = launches
    # phase 7 holds its elastic run to this uninterrupted one, phase 10
    # its rank runs to the state after step DIST_STEPS
    run = dict(cfg=cfg, graph=prog.graph, feeds=feeds, weights=ws,
               losses=losses,
               final={"weights": sess.weights, "m": sess.opt_state["m"],
                      "v": sess.opt_state["v"]}, at_dist=at_dist)
    del sess, ex
    torch.cuda.empty_cache()

    # the pipeline path: reduced Llama, tp2 x pp2, two microbatches, 1f1b
    lcfg = get_config("llama_32b").reduced()
    print(f"  {lcfg.name} reduced ({lcfg.n_layers} layers, d_model "
          f"{lcfg.d_model}, {lcfg.n_heads} heads of {lcfg.hd}), batch "
          f"{IR_BATCH}, seq {IR_SEQ}, tp2 x pp2, 2 microbatches, 1f1b")
    lprog = block_program(lcfg, batch=IR_BATCH, seq=IR_SEQ, dp=1, tp=2, pp=2)
    rng = np.random.default_rng(0)
    lfeeds = block_feeds(lcfg, rng, IR_BATCH, IR_SEQ)
    lws = block_weights(lprog, rng)
    sim = api.Session(lprog, 0, executor=api.SimulatorExecutor())
    sim.load(lws)
    want = sim.train_step(dict(lfeeds), num_microbatches=2)
    lex = api.TorchExecutor()
    lsess = api.Session(lprog, 0, executor=lex)
    lsess.load(lws)
    ltplan = lprog.compile_train(0, num_microbatches=2)
    lstats = lex.lowered(ltplan, [ltplan.loss_name] + [
        ltplan.grad_map[t.name] for t in ltplan.graph.parameters()], 2).stats
    before = fa.launches
    t0 = time.perf_counter()
    r = lsess.train_step(dict(lfeeds), num_microbatches=2, schedule="1f1b")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = fa.launches - before
    want_launches = lcfg.n_layers * 2
    print(f"  step: {wall * 1e3:.1f} ms, B1 launches {got} (the lowered "
          f"graph dispatches {lstats.kernel_dispatches} a microbatch; "
          f"expected {want_launches}: layers x one class x 2 microbatches)")
    if got != want_launches or \
            lstats.kernel_dispatches * 2 != want_launches or \
            lstats.ref_dispatches:
        fail(f"graph IR pipeline: B1 launches {got}, dispatches "
             f"{lstats.kernel_dispatches} on B1 and "
             f"{lstats.ref_dispatches} plain, expected {want_launches}")
    check_against_simulator("Llama reduced tp2 x pp2 m=2",
                            r, want.loss, {n: want.grad_value(n)
                                           for n in lws})
    timing["launches"] += got
    return timing, run


def learnable_batch(torch, rng, batch, seq):
    """``tests/test_training.py``'s memorizable pattern at this shape: next
    token = (token + 1) % 64, each row from a random start."""
    import numpy as np
    start = rng.integers(0, 64, (batch, 1))
    tokens = (start + np.arange(seq)[None]) % 64
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to("cuda"),
            "labels": torch.from_numpy(((tokens + 1) % 64)
                                       .astype(np.int32)).to("cuda")}


def learnable_inputs(torch, cfg, rng, batch, seq):
    """:func:`learnable_batch` in the config's input kind, as
    ``launch.train.make_batch`` turns tokens into inputs: embeddings
    one_hot(token % d_model) * 0.02 with the positions on all three M-RoPE
    streams, or N(0, 0.02^2) audio frames from ``rng`` beside the
    tokens."""
    from repro_torch.models.model import token_embeds
    out = learnable_batch(torch, rng, batch, seq)
    if cfg.input_kind == "embeds":
        out["embeds"] = token_embeds(out.pop("tokens"), cfg.d_model)
        out["positions3"] = torch.arange(
            seq, dtype=torch.int32, device="cuda").expand(3, batch, seq)
    elif cfg.input_kind == "audio":
        out["audio_embeds"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.encdec.n_frames, cfg.d_model)) * 0.02) \
            .float().to("cuda")
    return out


def train_config(arch, layers, experts=None):
    """The config at published widths, its depth cut to ``layers`` and its
    routed experts to ``experts`` where given (``launch.train``'s
    ``--layers`` and ``--experts``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    cfg = get_config(arch)
    if layers:
        cfg = cut_depth(cfg, layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=experts))
    return cfg


def train_launches_per_step(cfg) -> dict[str, int]:
    """Each kernel's launches in one training step: the layers that hold
    it x microbatches x 2 (the forward, and the backward's recompute of the
    block under remat; the backward itself runs the plain versions)."""
    return {k: n * TRAIN_MICRO * 2
            for k, n in expected_prefill_launches(cfg).items()}


def normwise(a, b, chunk=1 << 26):
    """||a - b|| / ||b|| (the largest |a| where b is zero), in float64 on
    the card a chunk of elements at a time: a published expert stack in
    float64 would take gigabytes.  Tensors on the host are copied there a
    chunk at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, b.numel(), chunk):
        x = a[i:i + chunk].to("cuda").double()
        y = b[i:i + chunk].to("cuda").double()
        num += (x - y).square().sum().item()
        den += y.square().sum().item()
    return math.sqrt(num / den) if den else a.abs().max().item()


def worst_normwise(pairs, skip=frozenset()):
    """The largest :func:`normwise` over (name, a, b), names in ``skip``
    left out -> (error, name)."""
    worst = (0.0, "")
    for name, a, b in pairs:
        if name not in skip:
            worst = max(worst, (normwise(a, b), name))
    return worst


def routing_flips(kern, plain, micro):
    """The tokens of one step routed differently in two runs: ``kern`` and
    ``plain`` are the step's ``moe.routing_log``s, (top_e, keep) a call,
    the calls of each microbatch (forward, then the remat recompute)
    consecutive; a token counts once however many of its calls differ."""
    if len(kern) != len(plain) or len(kern) % micro:
        fail(f"routing logs of {len(kern)} and {len(plain)} MoE calls for "
             f"{micro} microbatches")
    per = len(kern) // micro
    flips = 0
    for j in range(micro):
        hit = None
        for (ek, kk), (ep, kp) in zip(kern[j * per:(j + 1) * per],
                                      plain[j * per:(j + 1) * per]):
            d = (ek != ep).any(-1) | (kk != kp).any(-1)
            hit = d if hit is None else hit | d
        flips += int(hit.sum()) if hit is not None else 0
    return flips


class HostStage:
    """A float32 host buffer for one run's state, page-locked
    (``cudaHostRegister``) where CUDA allows it, so that copies to
    and from the card run at the link's rate; made once a phase and reused
    from config to config, since faulting in tens of GB of fresh host
    memory costs more than the copies.  :meth:`close` unlocks and frees
    it."""

    def __init__(self, torch, numel):
        t0 = time.perf_counter()
        self.torch = torch
        self.buf = torch.empty(numel, dtype=torch.float32)
        # fault every page in first, one element a 4 KiB page, on the
        # host's threads: registering untouched memory faults it in page
        # by page on one thread
        self.buf[::1024].zero_()
        try:
            self.pinned = int(torch.cuda.cudart().cudaHostRegister(
                self.buf.data_ptr(), numel * 4, 0)) == 0
        except AttributeError:      # a torch without the binding
            self.pinned = False
        print(f"  host stage: {numel * 4 / 1e9:.1f} GB, "
              f"{'page-locked' if self.pinned else 'pageable'}, made in "
              f"{time.perf_counter() - t0:.1f} s")

    def put(self, tensors) -> list:
        """Copy ``tensors`` (float32, on the card) in -> each one's flat
        view in the buffer."""
        need = sum(t.numel() for t in tensors)
        if need > self.buf.numel():
            fail(f"host stage of {self.buf.numel()} elements, {need} to put")
        views, pos = [], 0
        for t in tensors:
            view = self.buf[pos:pos + t.numel()]
            view.copy_(t.detach().reshape(-1), non_blocking=self.pinned)
            views.append(view)
            pos += t.numel()
        self.torch.cuda.synchronize()
        return views

    def close(self):
        if self.pinned:
            self.torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
        self.buf, self.pinned = None, False


def n_params(cfg) -> int:
    """A config's parameters, counted on the meta device."""
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(
        init_params(cfg, device="meta", generator=None)))


def train_kernels_vs_plain(torch, policy, cfg, kernels, per_step, stage,
                           seq=TRAIN_SEQ):
    """Two steps from one seeded init (default AdamW, fp32, TF32 off), once
    through the kernels and once through the plain versions on the card:
    the losses, every gradient at step 1 (both runs' from the same init,
    side by side on the card), every parameter (those that start at zero
    apart) and all of AdamW's m and v after step 2 (the kernels' run staged
    on the host while the plain run holds the card), each against its
    limit.  With MoE, each step's routing in both runs: where tokens of a
    step route differently (at most ROUTING_FLIP_MAX of them), that step
    and the next are held to FLIP_LOSS_RTOL and FLIP_NORMWISE in place of
    phase 6's limits.  ``stage``: the :class:`HostStage` for the kernels'
    state."""
    import numpy as np

    from repro_torch.data.pipeline import CorpusConfig, SyntheticCorpus
    from repro_torch.launch.train import make_batch
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         init_opt_state)
    from repro_torch.train.steps import accumulate_grads, build_train_step
    from repro_torch.tree import named_leaves

    def routed(pol, fn):
        """fn() under kernel policy ``pol`` -> (its result, each MoE call's
        routing in order)."""
        policy.set_policy(pol)
        moe.routing_log = [] if cfg.moe else None
        try:
            return fn(), moe.routing_log or []
        finally:
            moe.routing_log = None
            policy.set_policy("auto")

    def init():
        return init_params(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))

    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, max_len=seq))
    rng = np.random.default_rng(0)
    batches = [make_batch(corpus, cfg, TRAIN_BATCH, seq, rng, "cuda")
               for _ in range(2)]
    step = build_train_step(cfg, AdamWConfig(), TRAIN_MICRO)

    def grads(pol, params):
        return routed(pol, lambda: accumulate_grads(
            params, batches[0], cfg, TRAIN_MICRO))

    def step2(pol, params, opt):
        """Step 2 alone: its result, routing, card peak and time (phase
        11's anchors)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (params, opt, met), route = routed(
            pol, lambda: step(params, opt, batches[1]))
        torch.cuda.synchronize()
        return (params, opt, met, route, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    def state(params, opt):
        return list(named_leaves(params)) + [
            (f"{s}{n}", t) for s in ("m", "v")
            for n, t in named_leaves(opt[s])]

    seconds, mark = {}, [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    k, p = {}, {}
    before = {n: m.launches for n, m in kernels.items()}
    params = init()
    zero = {n for n, t in named_leaves(params) if not t.any()}
    (loss, gk), route_k1 = grads("auto", params)
    k["loss"] = [loss.item()]
    k["launches"] = {n: m.launches - before[n] for n, m in kernels.items()}
    part("kernels: step-1 gradients")
    (loss, gp), route_p1 = grads("ref", params)
    p["loss"] = [loss.item()]
    part("plain: step-1 gradients")
    grad_err = worst_normwise(
        (n, a, b) for (n, a), (_, b) in zip(named_leaves(gk),
                                             named_leaves(gp)))
    del gp
    part("compare gradients")
    opt = init_opt_state(params)
    apply_updates(params, gk, opt, AdamWConfig())
    del gk
    before = {n: m.launches for n, m in kernels.items()}
    params, opt, met, route_k2, k["step2_s"], k["step2_peak_bytes"] = \
        step2("auto", params, opt)
    k["loss"].append(met["loss"].item())
    k["launches"] = {n: k["launches"][n] + m.launches - before[n]
                     for n, m in kernels.items()}
    part("kernels: AdamW, step 2")
    views = stage.put([t for _, t in state(params, opt)])
    del params, opt, met
    torch.cuda.empty_cache()
    part("stage the kernels' state on the host")
    # the plain run from the same init
    before = {n: m.launches for n, m in kernels.items()}
    params = init()
    (loss, gp), _ = grads("ref", params)
    opt = init_opt_state(params)
    apply_updates(params, gp, opt, AdamWConfig())
    del gp
    params, opt, met, route_p2, p["step2_s"], p["step2_peak_bytes"] = \
        step2("ref", params, opt)
    p["loss"].append(met["loss"].item())
    p["launches"] = {n: m.launches - before[n] for n, m in kernels.items()}
    part("plain: init, step-1 gradients, AdamW, step 2")
    leaves = state(params, opt)
    n_par = len(list(named_leaves(params)))
    param_err = worst_normwise(
        ((n, views[i], t) for i, (n, t) in enumerate(leaves[:n_par])),
        skip=zero)
    zero_lr = max((
        ((views[i].to("cuda") - t.reshape(-1)).abs().max().item()
         / met["lr"].item(), n)
        for i, (n, t) in enumerate(leaves[:n_par]) if n in zero),
        default=(0.0, "none"))
    state_err = worst_normwise(
        (n, views[n_par + i], t) for i, (n, t) in enumerate(leaves[n_par:]))
    del params, opt, leaves, views
    torch.cuda.empty_cache()
    part("compare the state")
    flips = [routing_flips(route_k1, route_p1, TRAIN_MICRO),
             routing_flips(route_k2, route_p2, TRAIN_MICRO)]

    want = {kk: 2 * v for kk, v in per_step.items()}
    if k["launches"] != want or any(p["launches"].values()):
        fail(f"{cfg.name}: launches over two steps {k['launches']} through "
             f"the kernels (expected {want}), {p['launches']} through the "
             f"plain versions (expected none)")
    tokens = TRAIN_BATCH * seq
    if max(flips) > ROUTING_FLIP_MAX * tokens:
        fail(f"{cfg.name}: {flips} tokens a step routed differently through "
             f"the kernels, more than {ROUTING_FLIP_MAX:.0%} of {tokens}")
    # phase 6's limits up to the first step with a flip, the MoE limits
    # from there on
    lims = [(TRAIN_LOSS_RTOL, TRAIN_GRAD_NORMWISE, TRAIN_STATE_NORMWISE)
            if not any(flips[:i + 1]) else
            (FLIP_LOSS_RTOL, FLIP_NORMWISE, FLIP_NORMWISE) for i in range(2)]
    lerr = [abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])]
    (gerr, gname), (perr, pname) = grad_err, param_err
    (serr, sname), (zlr, zname) = state_err, zero_lr
    ok = (all(e <= lim[0] for e, lim in zip(lerr, lims))
          and gerr <= lims[0][1] and perr <= TRAIN_PARAM_NORMWISE
          and serr <= lims[1][2])
    print(f"  kernels vs plain versions, two steps from seed 0: losses "
          f"{k['loss']} vs {p['loss']} (rel {lerr[0]:.2e}, {lerr[1]:.2e}; "
          f"limits {lims[0][0]:.0e}, {lims[1][0]:.0e}); step-1 gradients "
          f"worst normwise {gerr:.2e} ({gname}; limit {lims[0][1]:.0e}); "
          f"after step 2, params worst normwise {perr:.2e} ({pname}; limit "
          f"{TRAIN_PARAM_NORMWISE:.0e}; the leaves that start at zero are "
          f"held by m and v), m and v worst normwise {serr:.2e} ({sname}; "
          f"limit {lims[1][2]:.0e}); the zero-start leaves' largest element "
          f"difference {zlr:.3g} x step 2's lr ({zname})"
          + (f"; MoE routing: {flips} of {tokens} tokens a step routed "
             f"differently (at most {ROUTING_FLIP_MAX:.0%})"
             if cfg.moe else "") + f": {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name}: training through the kernels disagrees with the "
             f"plain versions")
    print(f"  step 2 alone: {k['step2_s'] * 1e3:.1f} ms through the kernels, "
          f"{p['step2_s'] * 1e3:.1f} ms through the plain versions; card "
          f"peak {k['step2_peak_bytes'] / 2**30:.3f} / "
          f"{p['step2_peak_bytes'] / 2**30:.3f} GiB; the kernels' state "
          f"staged in {'page-locked' if stage.pinned else 'pageable'} host "
          f"memory; "
          f"seconds: " + ", ".join(f"{n} {v:.1f}" for n, v in
                                   seconds.items()))
    return {"step2_s": {"kernels": k["step2_s"], "plain": p["step2_s"]},
            "step2_peak_bytes": {"kernels": k["step2_peak_bytes"],
                                 "plain": p["step2_peak_bytes"]},
            "loss_rel": max(lerr), "loss_rel_steps": lerr,
            "grad_normwise": gerr, "grad_worst": gname,
            "param_normwise": perr, "param_worst": pname,
            "state_normwise": serr, "state_worst": sname,
            "zero_start_max_lr": zlr, "zero_start_worst": zname,
            "routing_flips": flips if cfg.moe else None,
            "staged_pinned": stage.pinned, "seconds": seconds,
            "limits": {"loss": [lim[0] for lim in lims],
                       "grad": lims[0][1], "param": TRAIN_PARAM_NORMWISE,
                       "state": lims[1][2]}}


def plain_backward_inputs(torch, kind, cfg, seq=TRAIN_SEQ):
    """The inputs one microbatch (4 x ``seq``) gives kernel ``kind`` in the
    model, as leaves that need a gradient, with the Function to call and
    a gradient for each output.  MLA's q and k take its nope + rope head
    dim, v its own."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import ssd_scan as sk
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s = TRAIN_BATCH // TRAIN_MICRO, seq

    def leaf(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .requires_grad_()
    if kind == "flash":
        h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dv = d
        if cfg.mla:
            d = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
            dv = cfg.mla.v_head_dim
        window = cfg.hybrid.window if cfg.hybrid else None
        leaves = [leaf(b, s, n, e).transpose(1, 2)
                  for n, e in ((h, d), (kh, d), (kh, dv))]
        leaves = [t.detach().requires_grad_() for t in leaves]

        def call(q, k, v):
            return fa.flash_attention_with_grad(q, k, v, causal=True,
                                                window=window)
        outs = [(b, h, s, dv)]
    elif kind == "ssd":
        sc = cfg.ssm
        nh, n = sc.n_heads(cfg.d_model), sc.d_state
        leaves = [leaf(b, s, nh, sc.head_dim, scale=0.5), leaf(b, s, nh),
                  leaf(nh, scale=0.3), leaf(b, s, 2 * n, scale=0.3)]

        def call(x, dt, a, bc):
            return sk.ssd_scan_with_grad(
                x, F.softplus(dt), -torch.exp(a), bc[..., :n], bc[..., n:],
                chunk=sc.chunk)[0]
        outs = [(b, s, nh, sc.head_dim)]
    else:
        w = cfg.hybrid.lru_width or cfg.d_model
        leaves = [leaf(b, s, w, scale=0.5), leaf(b, s, w), leaf(b, s, w),
                  leaf(w, scale=0.5)]

        def call(x, r, i, lam):
            return rk.rglru_scan_with_grad(x, torch.sigmoid(r),
                                           torch.sigmoid(i), lam)
        outs = [(b, s, w)]
    seeds = [torch.randn(o, generator=g, device="cuda") for o in outs]
    return call, leaves, seeds


def plain_backward_ms(torch, kind, cfg, calls=5, seq=TRAIN_SEQ):
    """One kernel call's backward in the training path -- the plain version
    recomputed from the saved inputs and differentiated -- as device time
    (``torch.profiler``, the mean of ``calls`` backward calls of one graph)
    and as issued from Python one by one (CUDA events), in ms."""
    from torch.profiler import ProfilerActivity, profile
    call, leaves, seeds = plain_backward_inputs(torch, kind, cfg, seq)
    out = call(*leaves)

    def back():
        torch.autograd.grad([out], leaves, seeds, retain_graph=True)
    host = eager_ms(back, iters=5, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            back()
        torch.cuda.synchronize()
    device = profile_device(torch, prof, 1.0)[0] / calls
    del out, prof
    return device, host


def span_split(prof) -> dict:
    """Device ms of a profiled training step by the program's spans
    (``repro_torch.spans``): for each of ``train.forward``,
    ``train.backward``, ``model.remat_recompute`` (inside the backward)
    and ``train.optimizer``, the kernels whose launch lies inside one of
    its ranges, matched by launch time as the benchmark matches them
    (``bench/trace.py``; the backward's kernels are launched from the
    autograd engine's thread); ``"kernels"``: every kernel of the step."""
    from bench import trace as tracing
    from repro_torch import spans
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        tr = tracing.load(path)
    out = {"kernels": sum(k[1] - k[0] for k in tr.kernels) / 1e3}
    for name in (spans.FORWARD, spans.BACKWARD, spans.REMAT,
                 spans.OPTIMIZER):
        ranges = [r for r in tr.ranges(name) if r[2] == name]
        out[name] = sum(k[1] - k[0] for ks in tr.launched_in(ranges)
                        for k in ks) / 1e3
    return out


def print_span_split(what, split) -> None:
    """One line of :func:`span_split`; fails if a span read nothing."""
    from repro_torch import spans
    fwd, bwd = split[spans.FORWARD], split[spans.BACKWARD]
    remat, adam = split[spans.REMAT], split[spans.OPTIMIZER]
    print(f"  where {what} goes (device time of the kernels launched inside "
          f"the program's spans): forward {fwd:.1f} ms, backward {bwd:.1f} "
          f"ms (the remat recompute {remat:.1f} ms inside it), AdamW "
          f"{adam:.1f} ms; together {(fwd + bwd + adam) / split['kernels']:.2%}"
          f" of the {split['kernels']:.1f} ms of kernels")
    if min(fwd, bwd, remat, adam) <= 0:
        fail(f"{what}: a span of the training step read no kernel: {split}")


def profile_device(torch, prof, wall_ms):
    """Device time of a profiled window: the kernels and copies (user
    annotations left out), the plain recomputes' kernels inside the
    backward's ``plain backward:`` ranges, and the busy share of
    ``wall_ms``."""
    from torch.autograd import DeviceType

    from repro_torch.kernels.autograd import RANGE_PREFIX
    busy = plain = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and \
                    not e.name.startswith(RANGE_PREFIX):
                busy += e.device_time_total / 1e3
        elif e.name.startswith(RANGE_PREFIX):
            plain += e.device_time_total / 1e3
    return busy, plain, busy / wall_ms


def training_stage(torch, archs=TRAIN_ARCHS, families=FAMILY_TRAIN):
    """One :class:`HostStage` for the configs of phase 6 (``archs``) and
    phase 12 (``families``), sized for the largest one's parameters, AdamW
    m and v: page-locking it took ~20 s for phase 12's 37 GB, so a phase
    makes one for all its configs.  (Kept from phase 6 to 12 it would hold
    those GB through phases 7-9's host copies.)"""
    cfgs = [train_config(arch, layers) for arch, layers in archs] + [
        train_config(arch, layers, experts)
        for arch, layers, experts, _ in families]
    return HostStage(torch, max(3 * n_params(cfg) for cfg in cfgs))


def phase_train_all(torch, policy, kernels, stage, archs=TRAIN_ARCHS):
    """Phase 6: each config of ``archs`` in turn, the kernels' state of
    each staged in ``stage``."""
    t_phase = time.perf_counter()
    out = {arch: phase_train(torch, policy, kernels, arch, layers, stage)
           for arch, layers in archs}
    print(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_train(torch, policy, kernels, arch, layers, stage):
    """The production trainer on the card: ``launch.train.main`` for
    ``TRAIN_STEPS`` steps, kernels against plain versions over two steps
    (the kernels' state staged in ``stage``, a :class:`HostStage`), the
    learning check, and where a step's time goes."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.launch import train as launch
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step
    from repro_torch.tree import tree_leaves

    cfg = train_config(arch, layers)
    per_step = train_launches_per_step(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"== phase 6: train {cfg.name} full width, {cfg.n_layers} layers"
          f"{' (depth cut)' if layers else ''}, batch {TRAIN_BATCH}, seq "
          f"{TRAIN_SEQ}, {TRAIN_MICRO} microbatches, remat, AdamW fp32 "
          f"({card_line()})")
    gc.collect()
    torch.cuda.empty_cache()
    for mod in kernels.values():
        mod.launches = 0
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
            str(TRAIN_MICRO), "--log-every", "1", "--seed", "0"]
    if layers:
        argv += ["--layers", str(layers)]
    t0 = time.perf_counter()
    res = launch.main(argv)
    launches = {k: m.launches for k, m in kernels.items()}
    step_ms = [round(t, 1) for t in res["step_ms"]]
    print(f"  launch.train.main: {time.perf_counter() - t0:.1f} s for "
          f"{TRAIN_STEPS} steps; step ms {step_ms}; {tokens / (min(res['step_ms'][1:]) / 1e3):.0f} tok/s at the "
          f"fastest later step; peak memory {res['peak_memory_gib']} GiB")
    print(f"  launches per step {res['launches']} (derived: {per_step}, "
          f"layers x {TRAIN_MICRO} microbatches x 2)")
    if any(s != per_step for s in res["launches"]) or launches != {
            k: v * TRAIN_STEPS for k, v in per_step.items()}:
        fail(f"{cfg.name}: kernel launches {res['launches']} a step, "
             f"{launches} in all; expected {per_step} a step")
    if not (np.isfinite(res["losses"]).all()
            and np.isfinite(res["grad_norms"]).all()):
        fail(f"{cfg.name}: non-finite losses {res['losses']} or gradient "
             f"norms {res['grad_norms']}")
    gc.collect()
    torch.cuda.empty_cache()

    agree = train_kernels_vs_plain(torch, policy, cfg, kernels, per_step,
                                   stage)
    gc.collect()
    torch.cuda.empty_cache()

    # learning on the memorizable batch; the last step profiled
    params = init_params(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    n_blocks = sum(t.numel() for t in tree_leaves(params["groups"]))
    n_head = params.get("lm_head", params["embed"]).numel()
    opt = init_opt_state(params)
    step = build_train_step(cfg, AdamWConfig(**LEARN), TRAIN_MICRO)
    rng = np.random.default_rng(0)
    losses, walls = [], []
    for i in range(LEARN_STEPS):
        batch = learnable_batch(torch, rng, TRAIN_BATCH, TRAIN_SEQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == LEARN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
        else:
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(met["loss"].item())
    learned = bool(np.isfinite(losses).all() and losses[-1] < losses[0])
    print(f"  learning ({LEARN_STEPS} steps on the learnable batch, "
          f"{LEARN}): losses {[round(x, 4) for x in losses]}; last / first "
          f"{losses[-1] / losses[0]:.3f}: {'ok' if learned else 'FAIL'}")
    if not learned:
        fail(f"{cfg.name}: the loss did not fall on the learnable batch")
    busy, plain_prof, _ = profile_device(torch, prof, walls[-1])
    unprofiled = float(np.median(walls[1:-1]))
    share = busy / unprofiled
    split = span_split(prof)
    fwd, bwd = split[spans.FORWARD], split[spans.BACKWARD]
    del opt, prof
    gc.collect()
    torch.cuda.empty_cache()

    kinds = [k for k, v in per_step.items() if v]
    calls = {k: per_step[k] // 2 for k in kinds}   # backward calls a step
    timed = {k: plain_backward_ms(torch, k, cfg) for k in kinds}
    plain = {k: t[0] for k, t in timed.items()}
    plain_step = sum(plain[k] * calls[k] for k in kinds)
    # matmul flops: 2 a weight and token forward, 4 backward, and 2 more
    # for the blocks' remat recompute (the head is not recomputed)
    flops = (6 * (n_blocks + n_head) + 2 * n_blocks) * tokens
    step_ms = min(res["step_ms"][1:])
    print(f"  step (launch.train.main, host clock, synchronized): "
          f"{step_ms:.1f} ms = {tokens / step_ms * 1e3:.0f} tok/s; "
          f"{flops / 1e12:.1f} TFLOP of weight matmuls a step = "
          f"{flops / step_ms / 1e9:.1f} TFLOP/s")
    print_span_split("the profiled learning step", split)
    print(f"  profiled learning step: device {busy:.1f} ms (torch.profiler) "
          f"against {unprofiled:.1f} ms host for an unprofiled step "
          f"({share:.1%} busy; {walls[-1]:.1f} ms under the profiler); the "
          f"plain recomputes' kernels (their profiler ranges) {plain_prof:.1f}"
          f" ms = {plain_prof / bwd:.1%} of the backward")
    print(f"  plain recompute in the backward, per call (device time; "
          f"issued from Python one by one): " + ", ".join(
              f"{k} {timed[k][0]:.3f} ms ({timed[k][1]:.3f} ms) x {calls[k]}"
              for k in kinds)
          + f" = {plain_step:.1f} ms of device time a step, "
          f"{plain_step / bwd:.1%} of the backward")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": f"{cfg.name}, {cfg.n_layers} layers, batch "
                      f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MICRO} "
                      f"microbatches",
            "launches": launches, "launches_per_step": res["launches"][-1],
            "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "matmul_tflop": flops / 1e12,
            "peak_memory_gib": res["peak_memory_gib"],
            "busy_share": share, "forward_ms": fwd, "backward_ms": bwd,
            "remat_ms": split[spans.REMAT],
            "adamw_ms": split[spans.OPTIMIZER], "plain_backward_ms": plain,
            "plain_backward_share": plain_step / bwd,
            "plain_backward_host_ms": {k: t[1] for k, t in timed.items()},
            "plain_profiler_ms": plain_prof, "learn_losses": losses,
            **agree}

def probe_state(session):
    """The probe session's gathered weights, m and v (the state the
    probe's oracle holds bit for bit)."""
    from repro_torch.core.simulator import gather
    out = {n: gather(st) for n, st in session.weights.items()}
    for key in ("m", "v"):
        out.update({f"{key}/{n}": gather(st)
                    for n, st in session.opt_state[key].items()})
    return out


def check_probe(what, driver, losses, n_steps, m, transitions=()):
    """An elastic probe run against the port's uninterrupted reference
    run on its numpy ``SimulatorExecutor``: weights, m and v bitwise and
    losses within rtol 1e-5; every switch on the torch lowering."""
    import numpy as np

    from repro_torch import api
    from repro_torch.elastic.fixtures import probe_layout, reference_run
    ref, ref_losses = reference_run(probe_layout([0, 1, 2, 3], "dp"),
                                    n_steps, executor=api.SimulatorExecutor(),
                                    num_microbatches=m)
    want, got = probe_state(ref), probe_state(driver.session)
    drifted = [k for k in want if not np.array_equal(got[k], want[k])]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    sim = [t.kind for t in transitions
           if t.report.src_name != t.report.dst_name
           and "move" not in t.report.execute_seconds]
    print(f"  {what}: {len(losses)} steps, transitions "
          f"{[t.kind for t in transitions]}; weights, m, v bitwise: "
          f"{'yes' if not drifted else drifted}; losses rel {lerr:.1e}")
    if drifted or lerr > LOSS_RTOL or len(losses) != n_steps or sim:
        fail(f"elastic {what}: disagrees with the reference run, or "
             f"switched off the torch lowering ({sim})")


def phase_probe_traces():
    """Phase 7 (a): the probe traces on ``TorchExecutor()`` (cuda), each
    bitwise against the reference run; then a kill + join mid-transition
    and a crash resumed on another device set."""
    import tempfile

    from repro_torch import api
    from repro_torch.elastic import ElasticDriver, Fault, FaultPlan
    from repro_torch.elastic.fixtures import (probe_feeds, probe_graph,
                                              probe_provider, probe_values)

    def driver(**kw):
        return ElasticDriver(probe_graph(), probe_values(), probe_provider(),
                             probe_feeds, executor=api.TorchExecutor(), **kw)

    t0 = time.perf_counter()
    for key, (trace, kinds) in PROBE_TRACES.items():
        d = driver(num_microbatches=2)
        run = d.run(trace, 6)
        if run.transition_kinds() != kinds:
            fail(f"elastic:trace/{key}: transitions "
                 f"{run.transition_kinds()}, expected {kinds}")
        check_probe(f"elastic:trace/{key}", d, run.losses, 6, 2,
                    run.transitions)
    faults = FaultPlan((Fault(2, "kill", (2, 3)), Fault(4, "join", (2,)),
                        Fault(4, "kill", (2,), phase="mid-transition")))
    d = driver(faults=faults)
    run = d.run([(0, (0, 1, 2, 3), "dp")], 6)
    kinds = {(t.step, t.trigger): t.kind for t in run.transitions}
    if kinds != {(2, "fault"): "shrink", (4, "fault"): "grow",
                 (4, "mid-transition"): "shrink"}:
        fail(f"elastic kill + join mid-transition: transitions {kinds}")
    check_probe("kill 2,3 at 2; join 2 at 4, killed mid-transition", d,
                run.losses, 6, 1, run.transitions)
    with tempfile.TemporaryDirectory() as ck:
        d = driver(checkpoint_every=2, ckpt_dir=ck, faults=FaultPlan(
            (Fault(4, "crash", phase="post-checkpoint"),)))
        trace = [(0, (0, 1, 2, 3), "dp")]
        run = d.run(trace, 8)
        run2 = d.resume(trace, 8, ranks=(4, 5), layout="pp")
        if run.interrupted_at != 4 or \
                [s.step for s in run2.steps] != [4, 5, 6, 7] or \
                run2.steps[0].ranks != (4, 5):
            fail(f"elastic crash + resume: interrupted at "
                 f"{run.interrupted_at}, resumed steps "
                 f"{[s.step for s in run2.steps]}")
        check_probe("crash after step 4's checkpoint, resumed as pp on 4,5",
                    d, run.losses + run2.losses, 8, 1,
                    run.transitions + run2.transitions)
    print(f"  probe traces: {time.perf_counter() - t0:.1f} s")


def phase_elastic(torch, fa, ir_run):
    """Phase 7: the elastic driver and dynamic switching on the card.
    (a) the probe traces, bitwise; (b) phase 5's full-width program
    through ``ElasticDriver`` on ``TorchExecutor()``, shrinking to tp2 and
    growing back, each switch bitwise against the simulator's migration
    of the same state, the run against phase 5's uninterrupted one; (c)
    the search validator's ``("sim", "torch")`` check on the card.
    Returns the numbers of (b) and B1's launches there."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.core.switching import execute_switch
    from repro_torch.elastic import ElasticDriver
    from repro_torch.models.graph_block import block_strategy
    from repro_torch.search import cpu_cluster, search, tiny_spec

    cfg = ir_run["cfg"]
    print(f"== phase 7: elastic training and dynamic switching on "
          f"TorchExecutor (cuda)")
    t_phase = time.perf_counter()
    phase_probe_traces()

    # (b) full width: phase 5's graph (the driver's programs re-annotate
    # it; phase 5's is done with it), weights and feeds
    g = ir_run["graph"]
    strategies = {(0, 1, 2, 3): block_strategy(g, dp=2, tp=2),
                  (0, 1): block_strategy(g, dp=1, tp=2, devices=[0, 1])}
    print(f"  {cfg.name} full width, {IR_LAYERS} layers, batch {IR_BATCH}, "
          f"seq {IR_SEQ}: trace {ELASTIC_TRACE} with "
          f"{' / '.join(s.name for s in strategies.values())}, phase 5's "
          f"weights and feeds")
    marks = []

    def feeds(step):          # called just before each step's train_step
        marks.append(fa.launches)
        return ir_run["feeds"]

    switches = []

    class CheckedDriver(ElasticDriver):
        """Holds each switch to the simulator's migration of the same
        pre-switch state, and profiles the grow."""

        def _transition(self, step, target, layout, trigger, run):
            sess = self.session
            before = {"weights": sess.weights, "m": sess.opt_state["m"],
                      "v": sess.opt_state["v"]}
            src = sess.plan.strategy_index
            grow = len(target) > len(self.ranks)
            if grow:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    super()._transition(step, target, layout, trigger, run)
                    torch.cuda.synchronize()
            else:
                super()._transition(step, target, layout, trigger, run)
            rec = run.transitions[-1]
            rep = rec.report
            dst = sess.plan.strategy_index
            t0 = time.perf_counter()
            bad = []
            for key, state in before.items():
                want = execute_switch(state, sess.program.graph, src, dst,
                                      sess.shape_env, backend="sim",
                                      report=rep)
                got = sess.weights if key == "weights" \
                    else sess.opt_state[key]
                bad += [f"{key}/{n}" for n, st in want.items()
                        if st.parts.keys() != got[n].parts.keys()
                        or not all(np.array_equal(got[n].parts[d], a)
                                   for d, a in st.parts.items())]
            sim_s = time.perf_counter() - t0
            parts = rep.execute_seconds
            row = dict(step=step, kind=rec.kind, src=rep.src_name,
                       dst=rep.dst_name, messages=rep.message_count,
                       mb=rep.total_bytes / 1e6,
                       plan_ms=rep.planning_seconds * 1e3,
                       wall_ms=rep.wall_seconds * 1e3,
                       **{f"{k}_ms": v * 1e3 for k, v in parts.items()},
                       sim_check_s=sim_s, bitwise=not bad)
            if grow:
                dev, _, _ = device_breakdown(prof)
                row["device_ms"] = sum(dev.values())
                row["device_parts_ms"] = dev
                row["busy"] = row["device_ms"] / row["wall_ms"]
                row["profiled"] = True
            switches.append(row)
            print(f"  switch at step {step}: {rec.kind} {rep.src_name} -> "
                  f"{rep.dst_name}: {rep.message_count} msgs, "
                  f"{row['mb']:.1f} MB, plan {row['plan_ms']:.1f} ms, wall "
                  f"{row['wall_ms']:.1f} ms{' (profiled)' if grow else ''};"
                  f" weights + m + v: lower {row['lower_ms']:.1f} ms, pack + "
                  f"copy to the device {row['pack_ms']:.1f} ms, row moves on "
                  f"the device {row['move_ms']:.1f} ms, copy back + unpack "
                  f"{row['unpack_ms']:.1f} ms" + (
                      f"; device {row['device_ms']:.1f} ms ({row['busy']:.1%}"
                      f" busy: " + ", ".join(f"{k} {v:.1f} ms"
                                             for k, v in dev.items()) + ")"
                      if grow else "")
                  + f"; vs the simulator's migration ({sim_s:.1f} s): "
                  f"{'bitwise' if not bad else bad}")
            if bad or "move" not in parts:
                fail(f"elastic switch at step {step}: not bitwise the "
                     f"simulator's migration: {bad}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ex = api.TorchExecutor()
    driver = CheckedDriver(g, ir_run["weights"],
                           lambda ranks, layout=None: strategies[tuple(ranks)],
                           feeds, executor=ex)
    t0 = time.perf_counter()
    run = driver.run(ELASTIC_TRACE, len(ELASTIC_TRACE))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    marks.append(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = [b - a for a, b in zip(marks, marks[1:])]
    sess = driver.session
    dispatches = []
    for rec in run.steps:
        tplan = sess.program.compile_train(sess.program.index(rec.strategy))
        fetch = [tplan.loss_name] + [tplan.grad_map[t.name]
                                     for t in tplan.graph.parameters()]
        dispatches.append(ex.lowered(tplan, fetch).stats.kernel_dispatches)
    lrel = [abs(a - b) / abs(b) for a, b in zip(run.losses,
                                                ir_run["losses"])]
    for rec, n, want, r in zip(run.steps, per_step, dispatches, lrel):
        print(f"  step {rec.step + 1} under {rec.strategy}: loss "
              f"{rec.loss:.9e} (phase 5 rel {r:.1e}), "
              f"{rec.wall_seconds * 1e3:.1f} ms, B1 launches {n} (the "
              f"lowered graph dispatches {want})")
    if run.transition_kinds() != ["shrink", "grow"]:
        fail(f"elastic: transitions {run.transition_kinds()}")
    if per_step != dispatches or not all(dispatches):
        fail(f"elastic: B1 launches {per_step}, dispatched {dispatches}")
    if max(lrel) > LOSS_RTOL:
        fail(f"elastic: losses {run.losses} vs phase 5's "
             f"{ir_run['losses']}")
    # the key biases' m and v are left out: their gradient is zero up to
    # rounding (softmax is shift-invariant along the keys), so both runs'
    # m and v there are rounding noise, as phase 5 leaves their gradients
    # out of its normwise check; their weights stay in.  Both runs end
    # under dp2 x tp2, so the norms run over the same shards on both
    # sides (each replica counted on both, which leaves the ratio as is)
    def flat(st):
        return torch.from_numpy(flat_parts(st))

    t_cmp = time.perf_counter()
    worst = {}
    for key, final in ir_run["final"].items():
        got = sess.weights if key == "weights" else sess.opt_state[key]
        if any(repr(got[n].annot) != repr(st.annot)
               for n, st in final.items()):
            fail(f"elastic: the {key} end under another layout than "
                 f"phase 5's")
        worst[key] = worst_normwise(
            ((n, flat(got[n]), flat(st)) for n, st in final.items()),
            skip={n for n in final
                  if key != "weights" and n.endswith("/bk")})
    t_cmp = time.perf_counter() - t_cmp
    limits = {"weights": TRAIN_PARAM_NORMWISE, "m": TRAIN_STATE_NORMWISE,
              "v": TRAIN_STATE_NORMWISE}
    print(f"  after step 3 against phase 5's uninterrupted dp2 x tp2 run "
          f"(normwise; key biases' m and v left out): " + ", ".join(
              f"{k} {e:.2e} ({n}; limit {limits[k]:.0e})"
              for k, (e, n) in worst.items())
          + f" ({t_cmp:.1f} s); run {wall:.1f} s (the checks against the "
          f"simulator included), peak memory "
          f"{peak:.2f} GiB")
    if any(e > limits[k] for k, (e, _) in worst.items()):
        fail("elastic: the state after step 3 drifted from phase 5's run")
    launches = sum(per_step)
    del driver, sess, ex
    torch.cuda.empty_cache()

    # (c) the search validator on the card
    t0 = time.perf_counter()
    result = search(cpu_cluster(4), tiny_spec(), global_batch=16,
                    seq_len=256, validate_top=2, repeats=1,
                    executors=("sim", "torch"))
    executed = result.validation.executed
    for e in executed:
        print(f"  validator: {e.describe()}; error {e.error}")
    print(f"  validator ('sim', 'torch') on the card: "
          f"{time.perf_counter() - t0:.1f} s")
    if len(executed) != 2 or not all(e.bit_exact is True and e.error is None
                                     for e in executed):
        fail("elastic: the validator's TorchExecutor is not bit-exact")
    t_phase = time.perf_counter() - t_phase
    print(f"  phase 7: {t_phase:.1f} s")
    return {"launches": launches, "launches_per_step": per_step,
            "dispatches_per_step": dispatches, "losses": run.losses,
            "loss_rel": lrel,
            "step_ms": [(rec.strategy, rec.wall_seconds * 1e3)
                        for rec in run.steps],
            "switches": switches, "peak_memory_gib": peak,
            "state_normwise": {k: e for k, (e, _) in worst.items()},
            "run_s": wall, "compare_s": t_cmp, "phase_s": t_phase}


def microbatch_states(api, tplan, feeds, weights):
    """Per-microbatch leaf states of a micro train plan, as ``Session``
    builds them: each placeholder's feed split along its microbatch dim
    and scattered under its annotation; the parameters shared."""
    import numpy as np
    m = tplan.num_microbatches
    states = [dict(weights) for _ in range(m)]
    for t in tplan.graph.placeholders():
        pieces = np.split(feeds[t.name], m, axis=tplan.mb_roles[t.name])
        for st, piece in zip(states, pieces):
            st[t.name] = api.scatter(piece, t.annots[tplan.strategy_index],
                                     rng=np.random.default_rng(0))
    return states


def runs_differ(want, got) -> list:
    """(microbatch, tensor, device) of every shard that is not bitwise
    equal."""
    import numpy as np
    return [(j, name, dev) for j, (a, b) in enumerate(zip(want, got))
            for name, st in a.items() for dev, part in st.parts.items()
            if not np.array_equal(b[name].parts[dev], part)]


def timed_schedule(torch, fa, ex, tplan, sched, states, fetches,
                   around=None):
    """One timed ``ex.run_schedule(tplan, sched, states, fetches)``, as
    phases 8 and 10 (d) measure it: the card's cache emptied, its peak,
    ``ex.times`` and the allocator's counts taken afresh, ``around`` (a
    context manager, or None) entered just around the run and the device
    sync.  Returns the results and the run's record: wall, pack, dispatch
    loop (wall - pack - fetch) and fetch (s), ``ex.times`` whole
    (``parts``), the card's peak (GiB), the allocator's counts, B1's
    launches and each microbatch's loss."""
    import contextlib

    import numpy as np

    from repro_torch import api

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_stats()
    ex.times.reset()
    before = fa.launches
    with around or contextlib.nullcontext():
        t0 = time.perf_counter()
        got = ex.run_schedule(tplan, sched, states, fetches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t = ex.times.as_dict()
    alloc = {k: torch.cuda.memory_stats().get(k, 0) - alloc0.get(k, 0)
             for k in ("num_device_alloc", "num_device_free",
                       "num_alloc_retries", "num_sync_all_streams")}
    return got, dict(
        wall_s=wall, pack_s=t["pack"], loop_s=wall - t["pack"] - t["fetch"],
        fetch_s=t["fetch"], parts=t,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, allocator=alloc,
        b1_launches=fa.launches - before,
        loss=[float(np.asarray(api.gather(r[tplan.loss_name])))
              for r in got])


def phase_async_exact():
    """Phase 8 (a): the torch versions of the reference's
    ``async:pipeline/{2,4,8}`` and ``async:train/4`` selftest cases on the
    card, async and serialized, bitwise against the port's simulator."""
    import numpy as np

    from repro_torch import api
    from repro_torch.api.testing import (loss_pipeline_program,
                                         loss_pipeline_values,
                                         zigzag_program, zigzag_values)

    t0 = time.perf_counter()

    def executors():
        return (api.SimulatorExecutor(), api.AsyncExecutor(),
                api.AsyncExecutor(serialize=True))

    def label(ex):
        serial = getattr(ex, "serialize", False)
        return f"{ex.name}{'/serialized' if serial else ''}"

    def same(a, b, what):
        for dev, part in a.parts.items():
            if not np.array_equal(b.parts[dev], part):
                fail(f"async exact: {what} dev {dev} differs from the "
                     f"simulator")

    xv, ws, want_y = loss_pipeline_values(seed=11)
    cases = 0
    for n in (2, 4, 8):
        prog = loss_pipeline_program(n, name=f"pipe{n}")
        runs = {}
        for ex in executors():
            sess = api.Session(prog, f"pipe{n}", executor=ex)
            sess.load(ws)
            for m in (1, 2, 4):
                for kind in (("1f1b", "gpipe", "interleaved") if m > 1
                             else ("1f1b",)):
                    r = sess.run({"X": xv}, fetches=["Y", "L"],
                                 num_microbatches=m, schedule=kind)
                    if not np.array_equal(r.value("Y"), want_y) or \
                            float(r.value("L")) != float(want_y.sum()):
                        fail(f"async exact: pipe{n} {label(ex)} m={m} {kind}")
                    runs[(label(ex), m, kind)] = r
        for (exn, m, kind), r in runs.items():
            if exn != "sim":
                cases += 1
                for t in ("Y", "L"):
                    same(runs[("sim", m, kind)].shards(t), r.shards(t),
                         f"pipe{n} {t} {exn} m={m} {kind}")
        lw = api.AsyncExecutor().lowered(prog.compile_train(f"pipe{n}"))
        n_virtual = prog.compile(f"pipe{n}").n_stages
        kinds = [ch.kind for ch in lw.channels]
        if len(lw.programs) != 2 * n_virtual or \
                (n_virtual > 1 and "p2p" not in kinds) or \
                (n >= 4 and "reduce" not in kinds):
            fail(f"async exact: pipe{n} lowered to {len(lw.programs)} "
                 f"programs, channels {kinds}")
        print(f"  pipe{n}: {len(lw.programs)} stage programs, channels "
              f"{kinds}; Y and L bitwise the simulator's at 7 (m, kind)")

    prog = loss_pipeline_program(4, name="pipe4")
    base = None
    for m, kind in ((1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (4, "gpipe")):
        for ex in executors():
            sess = api.Session(prog, "pipe4", executor=ex)
            sess.load(ws)
            r = sess.train_step({"X": xv}, num_microbatches=m, schedule=kind)
            if r.loss != float(want_y.sum()):
                fail(f"async exact: pipe4 train {label(ex)} loss {r.loss}")
            if base is None:
                base = (r, dict(sess.weights))
                continue
            cases += 1
            for t in ws:
                same(base[0].grads[t], r.grads[t],
                     f"pipe4 grad {t} {label(ex)} m={m} {kind}")
                same(base[1][t], sess.weights[t],
                     f"pipe4 weight {t} {label(ex)} m={m} {kind}")
    zx, zws, zy = zigzag_values(seed=13)
    zprog = zigzag_program(4, name="zig4")
    base = None
    for m in (1, 2, 4):
        for ex in executors():
            sess = api.Session(zprog, "zig4", executor=ex)
            sess.load(zws)
            r = sess.train_step({"X": zx}, num_microbatches=m,
                                schedule="interleaved")
            if r.loss != float(zy.sum()):
                fail(f"async exact: zig4 {label(ex)} m={m} loss {r.loss}")
            if base is None:
                base = r
                continue
            cases += 1
            for t in zws:
                same(base.grads[t], r.grads[t],
                     f"zig4 grad {t} {label(ex)} m={m}")
    print(f"  pipe4 training at 4 (m, kind) and zig4 interleaved v=2 at m 1, "
          f"2, 4: gradients and weights bitwise; {cases} async / serialized "
          f"runs against the simulator in {time.perf_counter() - t0:.1f} s")
    return cases


def device_activity(prof):
    """Device intervals of a profiled window: (kernel busy ms as the union
    of kernel intervals over all streams, the sum of kernel ms, copy ms
    (host<->device), the window's device span ms, kernel count)."""
    from torch.autograd import DeviceType
    kern, copies = [], 0.0
    lo, hi = float("inf"), 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        lo, hi = min(lo, a), max(hi, b)
        key = e.name.lower()
        if "memcpy" in key or "memset" in key:
            copies += (b - a) / 1e3
        else:
            kern.append((a, b))
    kern.sort()
    busy, end = 0.0, float("-inf")
    for a, b in kern:
        if b > end:
            busy += b - max(a, end)
            end = b
    return (busy / 1e3, sum(b - a for a, b in kern) / 1e3, copies,
            (hi - lo) / 1e3 if kern else 0.0, len(kern))


def phase_async(torch, fa, ref):
    """Phase 8: the async MPMD pipeline executor on the card.  (a) the
    exact-data selftest programs, bitwise the simulator's; (b) full-width
    Llama-32B blocks under tp2 x pp2, one 1F1B step of 2 microbatches
    through ``TorchExecutor``, ``AsyncExecutor`` and its serialized
    baseline, bitwise across the three, with the time split, the overlap,
    the device's concurrency, the ticks' device times, peak memory and the
    host syncs.  Returns B1's launches and timings at this path's shape
    and the numbers of (b)."""
    import contextlib
    import warnings

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.graph_block import block_program

    @contextlib.contextmanager
    def profiled_run(box):
        """The profiled run: ``torch.profiler`` on, host syncs warned of;
        ``box`` gets the profile and the sync warnings."""
        with warnings.catch_warnings(record=True) as caught, \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        box.update(prof=prof, syncs=[w for w in caught if "synchroniz"
                                     in str(w.message).lower()])

    print("== phase 8: the async MPMD pipeline executor (one stream per "
          "virtual stage, one for the channels)")
    t_phase = time.perf_counter()
    exact_cases = phase_async_exact()

    cfg = get_config("llama_32b")
    print(f"  (b) {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}), {PP_LAYERS} layers, batch "
          f"{PP_BATCH}, seq {IR_SEQ}, tp2 x pp2 on 4 virtual devices, "
          f"{PP_MICRO} microbatches, 1f1b")
    prog = block_program(cfg, batch=PP_BATCH, seq=IR_SEQ, n_layers=PP_LAYERS,
                         dp=1, tp=2, pp=2)
    rng = np.random.default_rng(0)
    feeds = block_feeds(cfg, rng, PP_BATCH, IR_SEQ)
    ws = block_weights(prog, rng)
    n_params = sum(w.size for w in ws.values())
    holder = api.Session(prog, 0, executor=api.SimulatorExecutor())
    holder.load(ws)
    del ws
    tplan = prog.compile_train(0, num_microbatches=PP_MICRO)
    fetches = [tplan.loss_name] + [tplan.grad_map[t.name]
                                   for t in tplan.graph.parameters()]
    states = microbatch_states(api, tplan, feeds, holder.weights)
    sched = tplan.schedule(PP_MICRO, "1f1b")
    print(f"  {n_params / 1e6:.1f} M parameters, random from seed 0 (numpy); "
          f"{len(sched.ticks)} ticks")

    executors = {"torch": api.TorchExecutor(), "async": api.AsyncExecutor(),
                 "serialized": api.AsyncExecutor(serialize=True),
                 "profiled": api.AsyncExecutor()}
    total_mem = torch.cuda.get_device_properties(0).total_memory
    want, runs = None, []
    lw = executors["async"].lowered(tplan, fetches)
    print("  " + lw.describe().replace("\n", "\n  "))
    fa.launches = 0
    for i, kind in enumerate(PP_RUNS):
        ex = executors[kind]
        label = f"run {i + 1} {kind}"
        lw = ex.lowered(tplan, fetches, PP_MICRO) if kind == "torch" \
            else ex.lowered(tplan, fetches)
        dispatches = lw.stats.kernel_dispatches
        if dispatches != PP_LAYERS or lw.stats.ref_dispatches:
            fail(f"async: {label} lowered {dispatches} attention classes "
                 f"on B1 and {lw.stats.ref_dispatches} plain, expected "
                 f"{PP_LAYERS} on B1")
        profiled = kind == "profiled"
        box: dict = {}
        got, rec = timed_schedule(torch, fa, ex, tplan, sched, states,
                                  fetches, profiled_run(box) if profiled
                                  else None)
        rec["executor"] = kind
        wall, loop, launched = rec["wall_s"], rec["loop_s"], \
            rec["b1_launches"]
        peak = rec["peak_gib"] * 2**30
        print(f"  {label}: wall {wall:.3f} s = pack {rec['pack_s']:.3f} + "
              f"dispatch loop {loop:.3f} + fetch {rec['fetch_s']:.3f} s; B1 "
              f"launches {launched} (dispatches {dispatches} x "
              f"{PP_MICRO}); peak {rec['peak_gib']:.2f} GiB; allocator "
              f"{rec['allocator']}; losses "
              + ", ".join(f"{x:.9e}" for x in rec["loss"]))
        if launched != dispatches * PP_MICRO:
            fail(f"async: {label} launched B1 {launched} times, expected "
                 f"{dispatches * PP_MICRO}")
        if peak >= total_mem:
            fail(f"async: {label} peak {peak} B over the card's {total_mem}")
        if not all(np.isfinite(rec["loss"])):
            fail(f"async: {label} losses {rec['loss']}")
        if want is None:
            want = got
        else:
            bad = runs_differ(want, got)
            print(f"    loss and {len(fetches) - 1} gradients x "
                  f"{PP_MICRO} microbatches vs torch: "
                  f"{'bitwise' if not bad else f'{len(bad)} shards differ'}")
            if bad:
                fail(f"async: {label} differs from TorchExecutor at "
                     f"{bad[:6]}")
        del got
        if kind != "torch":
            ticks = {}
            first = lw.last_ticks[0]
            for r in lw.last_ticks:
                ticks.setdefault(r.stage, [])
                if len(ticks[r.stage]) < 4:
                    ticks[r.stage].append(
                        (r.microbatch, r.phase,
                         first.start.elapsed_time(r.start),
                         first.start.elapsed_time(r.end),
                         (r.host_start - first.host_start) * 1e3,
                         (r.host_end - first.host_start) * 1e3))
            rec["ticks"] = ticks
            for stage, tk in sorted(ticks.items()):
                print(f"    stage {stage} first ticks (mb phase: device "
                      f"start..end | host issue start..end, ms from the "
                      f"first tick's): " + "; ".join(
                          f"{mb} {ph}: {a:.1f}..{b:.1f} | {c:.1f}..{d:.1f}"
                          for mb, ph, a, b, c, d in tk))
        if profiled:
            busy, ksum, copies, span, nk = device_activity(box["prof"])
            if not nk:
                fail("async: torch.profiler saw no kernel on the device")
            rec.update(kernel_busy_ms=busy, kernel_sum_ms=ksum,
                       copy_ms=copies, device_span_ms=span, kernels=nk)
            where: dict = {}
            for w in box["syncs"]:
                key = f"{Path(w.filename).name}:{w.lineno}"
                where[key] = where.get(key, 0) + 1
            rec["host_syncs"] = where
            print(f"    torch.profiler: kernels busy {busy:.1f} ms (union "
                  f"over streams), kernel time summed over streams "
                  f"{ksum:.1f} ms (concurrency {ksum / busy:.3f}), copies "
                  f"{copies:.1f} ms, {nk} kernels; over the wall "
                  f"{wall * 1e3:.1f} ms: kernels busy {busy / wall / 10:.1f}%"
                  f", over the dispatch loop {loop * 1e3:.1f} ms: "
                  f"{busy / loop / 10:.1f}%")
            print(f"    host syncs under set_sync_debug_mode('warn'): "
                  f"{sum(where.values())} at "
                  + (", ".join(f"{k} x{n}" for k, n in sorted(where.items()))
                     or "none"))
        runs.append(rec)

    loop = {r["executor"]: r["loop_s"] for r in runs}
    overlap = 1 - loop["async"] / loop["serialized"]
    print(f"  overlap fraction of the dispatch loop 1 - async / serialized "
          f"(unprofiled runs) = 1 - {loop['async']:.3f} / "
          f"{loop['serialized']:.3f} = {overlap:.4f}")
    del states, holder, want
    torch.cuda.empty_cache()

    # B1 at this path's shape: a stage's two rows fold into the batch
    b, h = 2 * PP_BATCH // PP_MICRO, cfg.n_heads // 2
    shape = (f"B{b} H{h} K{cfg.n_kv_heads // 2} S{IR_SEQ} D{cfg.hd} causal "
             f"fp32 (async Llama-32B tp2 x pp2: a stage's 2 device rows "
             f"folded into the batch)")
    timing = b1_at_shape(torch, fa, ref, shape, b, h, cfg.n_kv_heads // 2,
                         IR_SEQ, cfg.hd)
    timing["launches"] = sum(r["b1_launches"] for r in runs)
    t_phase = time.perf_counter() - t_phase
    print(f"  phase 8: {t_phase:.1f} s")
    return timing, {"exact_cases": exact_cases, "params": int(n_params),
                    "overlap": overlap, "runs": runs, "phase_s": t_phase}


def phase_family(torch, policy, fa, ref, arch, layers, plen):
    """Serve one config of phase 9 at published widths (depth cut to
    ``layers``), fp32, random weights from seed 0, batch 4, ``plen``
    prompt positions and GEN generated tokens; see the module docstring."""
    import dataclasses

    import numpy as np

    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.train.steps import build_prefill_step
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = cut_depth(full, layers) if layers else full
    print(f"== phase 9: serve {arch}, published widths, {cfg.n_layers} of "
          f"{full.n_layers} layers; {card_line()}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"  {cfg.name}: d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"params fp32 ({weights / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f} s, init peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompt = serve.make_prompt(cfg, BATCH, plen, np.random.default_rng(0),
                               "cuda")
    # MoE is served from a copy under moe.exact (no drops) with the same
    # weights: at capacity_factor 1.25 a 4-token decode step has a
    # capacity of 1 and drops what prefill keeps, so only the exact copy's
    # teacher-forced decode can agree with its prefill.  The published
    # config's prefill is held to the plain versions below, and its decode
    # step is timed by where_the_time_goes
    served = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, exact=True)) if cfg.moe else cfg
    copy = " (moe.exact copy)" if cfg.moe else ""
    policy.set_policy("auto")
    prefill = build_prefill_step(cfg)
    build_prefill_step(served)(params, prompt)  # cuBLAS's first-call setup
    torch.cuda.reset_peak_memory_stats()
    for mod in serve.KERNELS.values():
        mod.launches = 0
    res = serve.generate(params, served, prompt, GEN)
    launches = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  served{copy}: prefill {BATCH}x{plen}: {res['prefill_ms']:.2f} ms"
          + (f"; encoder for decode {res['encode_ms']:.2f} ms"
             if cfg.encdec else "")
          + f"; cache fill ({plen} decode steps) {res['fill_ms']:.1f} ms; "
          f"decode {GEN - 1} steps {res['decode_ms']:.1f} ms = "
          f"{res['decode_tok_s']:.1f} tok/s; peak memory {peak:.2f} GiB")
    want = expected_prefill_launches(cfg)
    print(f"  kernel launches: prefill {res['prefill_launches']}, whole run "
          f"{launches} (expected {want} in prefill, none in decode)")
    if res["prefill_launches"] != want or launches != want:
        fail(f"{arch}: expected {want} launches in prefill and none in "
             f"decode; prefill {res['prefill_launches']}, whole run "
             f"{launches}")
    for key in ("prefill_logits", "teacher_logits"):
        if res[key].shape != (BATCH, cfg.vocab) or not bool(
                torch.isfinite(res[key]).all()):
            fail(f"{arch} {key}: shape {tuple(res[key].shape)} or "
                 f"non-finite")
    if tuple(res["tokens"].shape) != (BATCH, GEN):
        fail(f"{arch}: tokens shape {tuple(res['tokens'].shape)}")
    print("  sample (token ids):", res["tokens"][0, :16].tolist())
    print(f"  prefill vs teacher-forced decode logits{copy}: max |diff| "
          f"{res['max_abs_diff']:.3e} (atol 2e-3, rtol 1e-3, same argmax): "
          f"{'ok' if res['agree'] else 'FAIL'}")
    if not res["agree"]:
        fail(f"{arch}: prefill and teacher-forced decode logits disagree")

    # prefill through the kernels vs the plain versions on the card, each
    # MoE layer's routing recorded; these launches are not counted
    routes = {}
    moe.routing_log = []
    try:
        kern = prefill(params, prompt)
        routes["kernel"], moe.routing_log = moe.routing_log, []
        policy.set_policy("ref")
        plain = prefill(params, prompt)
        routes["plain"] = moe.routing_log
    finally:
        policy.set_policy("auto")
        moe.routing_log = None
    tokens = BATCH * plen
    flipped = torch.zeros(tokens, dtype=torch.bool, device="cuda")
    for (ek, kk), (ep, kp) in zip(routes["kernel"], routes["plain"]):
        flipped |= (ek != ep).any(-1) | (kk != kp).any(-1)
    n_flip = int(flipped.sum())
    clean = ~flipped.reshape(BATCH, plen).any(1)
    diff = (plain - kern)[clean].abs().max().item() if clean.any() else None
    same = bool(clean.any()) and bool(torch.allclose(
        plain[clean], kern[clean], atol=2e-3, rtol=1e-3)) and bool(
        (plain[clean].argmax(-1) == kern[clean].argmax(-1)).all())
    print(f"  prefill, kernels vs plain versions: {len(routes['kernel'])} "
          f"MoE layers routed, {n_flip} of {tokens} tokens routed "
          f"differently (at most {ROUTING_FLIP_MAX:.0%}); last-position "
          f"logits of the {int(clean.sum())} of {BATCH} prompts with no "
          f"such token: max |diff| {diff} (atol 2e-3, rtol 1e-3, same "
          f"argmax): {'ok' if same else 'FAIL'}")
    if n_flip > ROUTING_FLIP_MAX * tokens:
        fail(f"{arch}: {n_flip} tokens routed differently through the "
             f"kernels")
    if not same:
        fail(f"{arch}: prefill through the kernels disagrees with the plain "
             f"path")
    busy = where_the_time_goes(torch, cfg, params, prompt)
    out = {"arch": arch, "layers": cfg.n_layers, "params_b": n_params / 1e9,
           "weights_gb": weights / 1e9, "prompt": plen, "generated": GEN,
           "served": "moe.exact copy" if cfg.moe else "published",
           "prefill_ms": res["prefill_ms"], "encode_ms": res["encode_ms"],
           "fill_ms": res["fill_ms"], "decode_ms": res["decode_ms"],
           "decode_tok_s": res["decode_tok_s"], "peak_gib": peak,
           "busy": busy, "launches": launches,
           "b1_per_prefill": want["flash"],
           "decode_vs_prefill_max_diff": res["max_abs_diff"],
           "kernel_vs_plain_max_diff": diff, "routing_flips": n_flip,
           "tokens": tokens}
    del params, res, kern, plain, routes
    torch.cuda.empty_cache()
    return out


def phase_families(torch, policy, fa, ref):
    """Phase 9: each config of :data:`FAMILIES` in turn, then B1 against
    its plain version at each one's prefill shape (the MLA shape is phase
    3's)."""
    t_phase = time.perf_counter()
    runs = {arch: phase_family(torch, policy, fa, ref, arch, layers, plen)
            for arch, layers, plen in FAMILIES}
    b1 = {arch: b1_at_shape(torch, fa, ref, shape, BATCH, h, kh, plen, hd)
          for arch, shape, h, kh, plen, hd in (
              ("grok-1-314b", "B4 H48 K8 S512 D128 causal fp32 (Grok-1 "
               "prefill)", 48, 8, 512, 128),
              ("qwen2-vl-72b", "B4 H64 K8 S512 D128 causal fp32 (Qwen2-VL "
               "prefill)", 64, 8, 512, 128),
              ("whisper-large-v3", "B4 H20 K20 S384 D64 causal fp32 "
               "(Whisper decoder prefill)", 20, 20, 384, 64))}
    t_phase = time.perf_counter() - t_phase
    print(f"  phase 9: {t_phase:.1f} s")
    return runs, b1, t_phase


def phase_family_train(torch, policy, kernels, arch, layers, experts, seq,
                       stage):
    """Phase 12 for one config of :data:`FAMILY_TRAIN`: (a)
    ``launch.train.main`` for TRAIN_STEPS steps, (b) kernels against plain
    versions over two steps (MoE routing flips counted), (c) the learning
    check, (d) B1's plain-recompute backward at the config's shape.
    ``stage``: the :class:`HostStage` that (b) stages the kernels' run in."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launch
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step

    cfg = train_config(arch, layers, experts)
    per_step = train_launches_per_step(cfg)
    tokens = TRAIN_BATCH * seq
    cuts = [f"{cfg.n_layers} layers"] + (
        [f"{cfg.moe.n_experts} routed experts (top-{cfg.moe.top_k}, "
         f"{cfg.moe.n_shared} shared)"] if cfg.moe else [])
    print(f"== phase 12: train {cfg.name} published widths, "
          f"{', '.join(cuts)}, batch {TRAIN_BATCH}, seq {seq}, {TRAIN_MICRO} "
          f"microbatches, remat, AdamW fp32 ({card_line()})")
    gc.collect()
    torch.cuda.empty_cache()
    for mod in kernels.values():
        mod.launches = 0
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(seq), "--microbatches",
            str(TRAIN_MICRO), "--log-every", "1", "--seed", "0"]
    if layers:
        argv += ["--layers", str(layers)]
    if experts:
        argv += ["--experts", str(experts)]
    # (a) the entry point
    t0 = parts = time.perf_counter()
    seconds = {}

    def part(name):
        nonlocal parts
        seconds[name], parts = time.perf_counter() - parts, \
            time.perf_counter()
    res = launch.main(argv)
    launches = {k: m.launches for k, m in kernels.items()}
    step_ms = min(res["step_ms"][1:])
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"  launch.train.main: {time.perf_counter() - t0:.1f} s for "
          f"{TRAIN_STEPS} steps; step ms {[round(t, 1) for t in res['step_ms']]}"
          f"; {tokens / step_ms * 1e3:.0f} tok/s at the fastest later step; "
          f"peak memory {res['peak_memory_gib']:.2f} of {total:.2f} GiB "
          f"({total - res['peak_memory_gib']:.2f} free); losses "
          f"{res['losses']}, gradient norms {res['grad_norms']}")
    print(f"  B1 launches per step {res['launches']} (derived: {per_step}, "
          f"decoder self-attention layers x {TRAIN_MICRO} microbatches x 2; "
          f"the model sends each of them to B1, which raises rather than "
          f"run the plain version on the card)")
    if any(s != per_step for s in res["launches"]) or launches != {
            k: v * TRAIN_STEPS for k, v in per_step.items()}:
        fail(f"{cfg.name}: kernel launches {res['launches']} a step, "
             f"{launches} in all; expected {per_step} a step")
    losses = res["losses"]
    if not (np.isfinite(losses).all() and np.isfinite(res["grad_norms"])
            .all()) or any(a == b for a, b in zip(losses, losses[1:])):
        fail(f"{cfg.name}: losses {losses} (finite, each step's its own) or "
             f"gradient norms {res['grad_norms']}")
    gc.collect()
    torch.cuda.empty_cache()
    part("a")

    # (b) kernels vs plain versions, two steps from one init
    agree = train_kernels_vs_plain(torch, policy, cfg, kernels, per_step,
                                   stage, seq=seq)
    gc.collect()
    torch.cuda.empty_cache()
    part("b")

    # (c) learning on the memorizable batch, until the loss falls; the
    # second step profiled (host events too, for the spans' split), the
    # later ones give the unprofiled wall
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = init_opt_state(params)
    step = build_train_step(cfg, AdamWConfig(**LEARN), TRAIN_MICRO)
    rng = np.random.default_rng(0)
    learn, walls = [], []
    for i in range(LEARN_STEPS):
        batch = learnable_inputs(torch, cfg, rng, TRAIN_BATCH, seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
        else:
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        learn.append(met["loss"].item())
        if i >= 2 and learn[-1] < learn[0]:
            break
    learned = bool(np.isfinite(learn).all() and learn[-1] < learn[0])
    learn_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  learning (on the learnable batch, {LEARN}, until the loss "
          f"falls, at most {LEARN_STEPS} steps): losses "
          f"{[round(x, 4) for x in learn]} in {len(learn)} steps; last / "
          f"first {learn[-1] / learn[0]:.3f}; peak {learn_peak:.2f} GiB: "
          f"{'ok' if learned else 'FAIL'}")
    if not learned:
        fail(f"{cfg.name}: the loss did not fall on the learnable batch")
    busy = profile_device(torch, prof, walls[1])[0]
    unprofiled = float(np.median(walls[2:]))
    share = busy / unprofiled
    split = span_split(prof)
    print_span_split("the profiled learning step", split)
    del params, opt, prof, batch
    gc.collect()
    torch.cuda.empty_cache()
    part("c")

    # (d) B1's backward: the plain version recomputed, per call
    back, back_host = plain_backward_ms(torch, "flash", cfg, seq=seq)
    calls = per_step["flash"] // 2
    part("d")
    print(f"  profiled learning step: device {busy:.1f} ms against "
          f"{unprofiled:.1f} ms host for an unprofiled step ({share:.1%} "
          f"busy); B1's plain recompute in the backward, per call: "
          f"{back:.3f} ms device "
          f"({back_host:.3f} ms issued from Python one by one) x {calls} a "
          f"step; seconds: " + ", ".join(f"({k}) {v:.1f}"
                                         for k, v in seconds.items()))
    return {"config": f"{cfg.name}, {', '.join(cuts)}, batch {TRAIN_BATCH} "
                      f"x {seq}, {TRAIN_MICRO} microbatches",
            "params_b": n_params(cfg) / 1e9,
            "launches": launches, "launches_per_step": res["launches"][-1],
            "losses": losses, "grad_norms": res["grad_norms"],
            "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_memory_gib": res["peak_memory_gib"], "busy_share": share,
            "plain_backward_ms": {"flash": back},
            "plain_backward_host_ms": {"flash": back_host},
            "span_ms": split, "learn_losses": learn, "learn_peak_gib": learn_peak,
            "seconds": seconds, **agree}


def phase_families_train(torch, policy, kernels, stage):
    """Phase 12: each config of :data:`FAMILY_TRAIN` in turn, freed before
    the next, the kernels' state of each staged in ``stage``."""
    t_phase = time.perf_counter()
    runs = {arch: phase_family_train(torch, policy, kernels, arch, layers,
                                     experts, seq, stage)
            for arch, layers, experts, seq in FAMILY_TRAIN}
    t_phase = time.perf_counter() - t_phase
    print(f"  phase 12: {t_phase:.1f} s")
    return runs, t_phase


def dryrun_child_main(path, gpu_name, part) -> int:
    """One part of phase 11 in a child process on the host (fake tensors
    and a fake process group: nothing is allocated and no card is touched):
    ``"roofline"``: the roofline of every applicable assigned arch x input
    shape on 16 x 16 with the card's constants; ``"full:<i>"``: the full
    dry run of ``DRYRUN_FULL[i]``, and with ``i == 0`` the anchor (phase
    6's Qwen2-1.5B training step, ``TRAIN_ARCHS[0]``, fp32, plain versions,
    on a 1 x 1 mesh), the same for each of phase 12's configs, and the
    collective bytes of phase 10 (e)'s MoE layer on its mesh.  Writes one
    JSON file to ``path``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.launch.specs import INPUT_SHAPES, InputShape
    t0 = time.perf_counter()
    out = {}
    if part == "roofline":
        out["roofline"] = []
        for arch in dryrun.assigned_archs():
            for shape in INPUT_SHAPES:
                r = roofline.roofline(arch, shape, gpu=gpu_name,
                                      verbose=False)
                r.pop("components", None)
                out["roofline"].append(r)
    else:
        i = int(part.split(":")[1])
        arch, shape = DRYRUN_FULL[i]
        out["full"] = [dryrun.dryrun_one(arch, shape, gpu=gpu_name,
                                         verbose=False)]
        if i == 0:
            def anchor(arch, layers, experts=None, seq=TRAIN_SEQ):
                return dryrun.dryrun_one(
                    arch, "anchor", gpu=gpu_name,
                    cfg=train_config(arch, layers, experts),
                    mesh=LogicalMesh(("data", "model"), (1, 1)),
                    shape=InputShape("anchor", seq, TRAIN_BATCH, "train"),
                    num_microbatches=TRAIN_MICRO, dtype=torch.float32,
                    verbose=False)
            out["anchor"] = anchor(*TRAIN_ARCHS[0])
            out["family_anchors"] = {f[0]: anchor(*f) for f in FAMILY_TRAIN}
            out["ep_layer"] = roofline.moe_component(
                get_config(EP_ARCH), LogicalMesh(("data", "model"), EP_MESH),
                EP_TOKENS, torch.float32)
    out["seconds"] = {part: time.perf_counter() - t0}
    Path(path).write_text(json.dumps(out))
    return 0


class DryRunChild:
    """Phase 11's dry run (:func:`dryrun_child_main`) in child processes,
    one a part, started after phase 5 beside the card phases at a lower
    priority (``nice`` 10: the card phases' host work goes first);
    :meth:`result` waits for them.  They are killed if the script ends
    first."""

    def __init__(self, out_dir, gpu_name):
        import atexit
        import os
        self.gpu = gpu_name
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS=str(DRYRUN_THREADS),
                   MKL_NUM_THREADS=str(DRYRUN_THREADS),
                   CUDA_VISIBLE_DEVICES="")
        parts = ["roofline"] + [f"full:{i}" for i in range(len(DRYRUN_FULL))]
        self.procs = []
        for part in parts:
            path = Path(out_dir) / f"dryrun-{part.replace(':', '-')}.json"
            self.procs.append((path, subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                 "chip_smoke.dryrun_child_main(*sys.argv[1:]))",
                 str(path), gpu_name, part], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, preexec_fn=lambda: os.nice(10))))
        atexit.register(self.stop)

    def stop(self) -> None:
        for _, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def result(self):
        """(the parts' reports merged, seconds waited for them)."""
        t0 = time.perf_counter()
        rep = {"gpu": self.gpu, "full": [], "seconds": {}}
        for path, proc in self.procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                fail(f"phase 11's dry run exited with {proc.returncode}:\n"
                     f"{out[-4000:]}")
            part = json.loads(path.read_text())
            path.unlink()
            rep["full"] += part.pop("full", [])
            rep["seconds"].update(part.pop("seconds"))
            rep.update(part)
        return rep, time.perf_counter() - t0


def gpu_name_from_smi() -> str:
    """The card's name as nvidia-smi gives it (phase 11's constants)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0] \
        .strip()


def phase_production_dryrun(child, train, famtrain) -> dict:
    """Phase 11: the dry run's report (the children started after phase
    5), the anchor's predicted peak against phase 6's measured plain-version peak
    of the same step, and the MFU the dry run's FLOPs and the measured
    step give on this card; then each of phase 12's configs the same way,
    held to ANCHOR_RTOL where the dry run ran no MoE, and recorded where
    its DTensor MoE stands in for the capacity dispatch phase 12 ran."""
    from repro_torch.launch.hardware import get_gpu
    from repro_torch.models.moe import DTENSOR_FORMULATIONS
    print("== phase 11: production dry run (fake world and tensors, in "
          "host children started after phase 5)")
    rep, waited = child.result()
    gpu = get_gpu(rep["gpu"])
    print(f"  card constants: {gpu.name}: bf16 {gpu.peak_flops['bfloat16']:.3g}"
          f" FLOP/s, fp32 {gpu.peak_flops['float32']:.3g}, HBM "
          f"{gpu.hbm_bw:.3g} B/s, NVLink {gpu.nvlink_bw:.3g} B/s a direction "
          f"in nodes of {gpu.node_gpus}, network {gpu.network_bw:.3g} B/s; "
          f"the parts took " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                         rep["seconds"].items())
          + f"; waited {waited:.1f} s")
    print("  (a) roofline on 16x16, per device (arch x shape: the step's "
          "arguments + the largest component's temps, terms, bottleneck, "
          "MODEL_FLOPS, useful share, MFU at the bound on 256 cards):")
    bad = []
    for r in rep["roofline"]:
        if "skipped" in r:
            print(f"    {r['arch']:18s} {r['shape']:12s} skipped: "
                  f"{r['skipped'][:40]}")
            continue
        t = r["roofline_seconds"]
        print(f"    {r['arch']:18s} {r['shape']:12s} "
              f"{r['bytes_per_device']['estimate'] / 2**30:6.2f} GiB, compute "
              f"{t['compute'] * 1e3:10.2f} ms, memory {t['memory'] * 1e3:10.2f}"
              f" ms, collective {t['collective'] * 1e3:10.2f} ms -> "
              f"{r['bottleneck']:10s} MODEL_FLOPS {r['model_flops_global']:.3e}"
              f", useful {r['useful_flops_ratio']:.2f}, MFU "
              f"{r['mfu_at_bound']:.4f}"
              + (f", MoE {r['moe']['formulation']}" if "moe" in r else ""))
        if r["gpu"] != gpu.name or r["chips"] != 256:
            bad.append(r["arch"])
    if bad:
        fail(f"phase 11: rooflines not on 256 {gpu.name}: {bad}")
    print("  (b) full dry runs, per device:")
    for r in rep["full"]:
        b, t = r["bytes_per_device"], r["roofline_seconds"]
        print(f"    {r['arch']} x {r['shape']} @ {r['mesh']}: args "
              f"{b['arguments'] / 2**30:.2f} GiB, temps "
              f"{b['temps'] / 2**30:.2f} GiB, peak {b['peak'] / 2**30:.2f} GiB"
              f"; flops {r['per_device']['flops']:.3e}, HBM "
              f"{r['per_device']['hbm_bytes']:.3e} B, collectives "
              f"{r['per_device']['collectives']}; -> {r['bottleneck']} "
              f"({r['run_s']:.0f} s)"
              + (f"; MoE {r['moe']['formulation']}" if "moe" in r else ""))
    print("  MoE on DTensors: " + "; ".join(
        f"{k}: {v}" for k, v in DTENSOR_FORMULATIONS.items()))
    a = rep["anchor"]
    arch, layers = TRAIN_ARCHS[0]
    got = train[arch]["step2_peak_bytes"]["plain"]
    step_s = train[arch]["step2_s"]["plain"]
    want = a["bytes_per_device"]["peak"]
    rel = (want - got) / got
    flops = a["per_device"]["flops"]
    mfu = flops / step_s / gpu.peak_flops["float32"]
    ok = abs(rel) <= ANCHOR_RTOL
    print(f"  (c) anchor: {arch} {layers} layers, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {TRAIN_MICRO} microbatches, remat, fp32, plain "
          f"versions, 1x1: predicted peak {want / 2**30:.3f} GiB (args "
          f"{a['bytes_per_device']['arguments'] / 2**30:.3f}), measured "
          f"{got / 2**30:.3f} GiB (phase 6, step 2 through the plain "
          f"versions): {rel:+.1%} (limit +-{ANCHOR_RTOL:.0%}): "
          f"{'ok' if ok else 'FAIL'}; {flops:.3e} FLOPs in the measured "
          f"{step_s * 1e3:.1f} ms: MFU {mfu:.3f} of fp32 peak")
    if not ok:
        fail("phase 11: the dry run's predicted peak misses phase 6's")
    anchor = {"predicted_peak_bytes": want, "measured_peak_bytes": got,
              "rel": rel, "flops": flops, "step_s": step_s, "mfu_fp32": mfu}
    families, missed = {}, []
    for arch, a in rep["family_anchors"].items():
        f = famtrain[arch]
        got = f["step2_peak_bytes"]["plain"]
        want = a["bytes_per_device"]["peak"]
        rel = (want - got) / got
        moe_form = a.get("moe", {}).get("formulation")
        held = moe_form is None
        flops, step_s = a["per_device"]["flops"], f["step2_s"]["plain"]
        mfu = flops / step_s / gpu.peak_flops["float32"]
        families[arch] = {"predicted_peak_bytes": want,
                          "measured_peak_bytes": got, "rel": rel,
                          "held": held, "moe": moe_form, "flops": flops,
                          "step_s": step_s, "mfu_fp32": mfu}
        print(f"  (c) {f['config']}, 1x1: predicted peak "
              f"{want / 2**30:.3f} GiB, measured {got / 2**30:.3f} GiB "
              f"(phase 12, step 2 through the plain versions): {rel:+.1%}"
              + (f" (limit +-{ANCHOR_RTOL:.0%}): "
                 f"{'ok' if abs(rel) <= ANCHOR_RTOL else 'FAIL'}" if held
                 else f", recorded, not held: the dry run's MoE is "
                      f"{moe_form!r}, not the capacity dispatch phase 12 "
                      f"ran")
              + f"; {flops:.3e} FLOPs in {step_s * 1e3:.1f} ms: MFU "
              f"{mfu:.3f}")
        if held and abs(rel) > ANCHOR_RTOL:
            missed.append(arch)
    if missed:
        fail(f"phase 11: the dry run's predicted peak misses phase 12's for "
             f"{missed}")
    return {"roofline": rep["roofline"], "full": rep["full"],
            "anchor": anchor, "family_anchors": families,
            "ep_layer": rep["ep_layer"], "seconds": rep["seconds"],
            "waited_s": waited}


def check_ep(ranks, ep_layer) -> dict:
    """Phase 10 (e)'s checks on rank 0's report."""
    e = ranks[0]["e"]
    ar = int(ep_layer["collectives"].get("all-reduce", 0))
    ok = (e["routing_bitwise"] and e["y_normwise"] <= EP_Y_NORMWISE
          and e["aux_rel"] <= EP_AUX_REL and e["staged_bytes"] == ar)
    peaks = [p / 2**30 for p in e["rank_peaks_bytes"]]
    print(f"  (e) {EP_ARCH} MoE layer at published widths, {EP_TOKENS} "
          f"tokens, fp32, expert-parallel on a {e['mesh']} mesh of the "
          f"ranks ({e['experts_per_rank']} experts a rank, each from its own "
          f"seed) vs rank 0's single-process capacity dispatch: routing "
          f"bitwise {e['routing_bitwise']}, y normwise {e['y_normwise']:.2e} "
          f"(limit {EP_Y_NORMWISE:.0e}), aux rel {e['aux_rel']:.2e} (limit "
          f"{EP_AUX_REL:.0e}); staged for the all-reduce "
          f"{e['staged_bytes']} B, the dry run's all-reduce on that mesh "
          f"{ar} B (its all-gather, {int(ep_layer['collectives'].get('all-gather', 0))}"
          f" B, is the shared experts' weights, which each rank builds "
          f"whole); EP call {e['ep_s'] * 1e3:.1f} ms, experts built in "
          f"{e['build_s']:.1f} s, reference built in {e['ref_build_s']:.1f} "
          f"s and run in {e['ref_s'] * 1e3:.1f} ms; card peak a rank "
          f"through the call {', '.join(f'{p:.2f}' for p in peaks)} GiB: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("phase 10 (e): the expert-parallel layer disagrees")
    return e


def flat_parts(st):
    """A ShardedTensor's parts raveled and concatenated in device order:
    every replica in its own place, so a replica that differs from its
    twin shows."""
    import numpy as np
    return np.concatenate([st.parts[d].ravel() for d in sorted(st.parts)])


def dist_reference(ir_run, out_dir) -> str:
    """Phase 5's first ``DIST_STEPS`` losses and its weights, AdamW m and
    v after step ``DIST_STEPS``, each leaf's parts in device order
    (``flat_parts``), one ``.npy`` file each (phase 10's rank 0 maps
    them), with each leaf's annotation; written once; returns the
    directory."""
    import numpy as np
    t0 = time.perf_counter()
    out = Path(out_dir)
    np.save(out / "losses.npy",
            np.asarray(ir_run["losses"][:DIST_STEPS], np.float64))
    names = {}
    for key, state in ir_run["at_dist"].items():
        for i, (name, st) in enumerate(sorted(state.items())):
            np.save(out / f"{key}-{i}.npy", flat_parts(st))
            names[f"{key}|{name}"] = [f"{key}-{i}.npy", repr(st.annot)]
    (out / "names.json").write_text(json.dumps(names))
    print(f"  phase 5's state after step {DIST_STEPS} written for phase 10 "
          f"({time.perf_counter() - t0:.1f} s)")
    return str(out)


def host_rss_gib() -> float:
    """This process's resident host memory now (GiB, ``VmRSS``)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def trim_host() -> float:
    """Collect garbage and return the freed heap to the system; returns
    the resident host memory left (GiB)."""
    import ctypes
    import gc
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    return host_rss_gib()


class HostPeak:
    """The largest resident host memory of this process while the block
    runs (GiB), sampled every 0.2 s by a thread."""

    def __enter__(self):
        import threading
        self.peak = host_rss_gib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.2):
                self.peak = max(self.peak, host_rss_gib())
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_gib())


def rank_steps(torch, fa, mesh, prog, cfg):
    """One rank's ``DIST_STEPS`` train steps of ``prog`` on
    ``DistExecutor``, from phase 5's weights and feeds (seed 0).  Returns
    the Session and this run's numbers: each step's loss, wall and split,
    B1's launches and the q and k shapes it took, the
    lowered graph's dispatches, traffic, the card's peak, the Session's
    host state and the process's peak host memory.  Each step's result is
    dropped before the next step runs: four ranks' host memory is what
    bounds this run."""
    import numpy as np

    from repro_torch import api
    launch = fa.flash_attention
    shapes = set()

    def recorded(q, k, v, **kw):     # the wrapper counts the launch
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return launch(q, k, v, **kw)
    fa.flash_attention = recorded
    try:
        with HostPeak() as host:
            t0 = time.perf_counter()
            rng = np.random.default_rng(0)
            feeds = block_feeds(cfg, rng, IR_BATCH, IR_SEQ)
            ws = block_weights(prog, rng)
            ex = api.DistExecutor(mesh)
            sess = api.Session(prog, 0, executor=ex)
            sess.load(ws)
            del ws
            setup_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            steps = []
            ex.times.sync = True
            fa.launches = 0
            for _ in range(DIST_STEPS):
                before = fa.launches
                ex.times.reset()
                t0 = time.perf_counter()
                r = sess.train_step(dict(feeds))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                steps.append(dict(loss=r.loss, wall_s=wall,
                                  launches=fa.launches - before,
                                  adamw_s=r.update_seconds,
                                  **ex.times.as_dict()))
                grad_bytes = sum(p.nbytes for st in r.grads.values()
                                 for p in st.parts.values())
                del r
    finally:
        fa.flash_attention = launch
    tplan = prog.compile_train(0)
    lw = ex.lowered(tplan, [tplan.loss_name] + [
        tplan.grad_map[t.name] for t in tplan.graph.parameters()])
    comm, fetch = lw.comm_stats, lw.fetch_stats
    out = dict(setup_s=setup_s, steps=steps, launches=fa.launches,
               b1_shapes=sorted(shapes),
               dispatches=lw.stats.kernel_dispatches,
               plain_dispatches=lw.stats.ref_dispatches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               host_state_gib=(grad_bytes + sum(
                   p.nbytes for tree in (sess.weights, sess.opt_state["m"],
                                         sess.opt_state["v"])
                   for st in tree.values() for p in st.parts.values()))
               / 2**30, host_peak_gib=host.peak,
               comm={k: getattr(comm, k) for k in (
                   "p2p_messages", "p2p_bytes", "collectives",
                   "staged_bytes", "uniform_reduce_stages",
                   "uniform_copy_stages", "stages", "copy_pairs",
                   "permute_rounds", "reduce_groups", "grouped_reduces")},
               fetch={k: getattr(fetch, k) for k in (
                   "collectives", "staged_bytes")})
    return sess, out


def pipeline_ticks(lw) -> list:
    """A rank's ticks of the last run: (virtual stage, microbatch, phase,
    device start and end in ms from the first tick's start)."""
    first = lw.last_ticks[0].start
    return [(r.stage, r.microbatch, r.phase,
             first.elapsed_time(r.start), first.elapsed_time(r.end))
            for r in lw.last_ticks]


def rank_pipeline(torch, fa, mesh, cfg):
    """Phase 10 (d) on one rank: phase 5's blocks under tp2 x pp2 (without
    the q/k/v biases, which the graph IR cannot microbatch), weights and
    feeds from seed 0, one interleaved 1F1B step of ``DIST_PP_MICRO``
    microbatches through ``run_schedule`` on ``DistAsyncExecutor``, then on
    ``DistExecutor``, fetching the loss and every gradient.  Returns this
    rank's numbers; rank 0 also holds the two runs against each other
    (bitwise) and against the stacked ``AsyncExecutor`` run of the same
    program, feeds and weights on its card (phase 5's limits)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.models.graph_block import block_program

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, qkv_bias=False)
    prog = block_program(cfg, batch=IR_BATCH, seq=IR_SEQ,
                         n_layers=IR_LAYERS, dp=1, tp=2, pp=2)
    rng = np.random.default_rng(0)
    feeds = block_feeds(cfg, rng, IR_BATCH, IR_SEQ)
    ws = block_weights(prog, rng)
    n_params = sum(w.size for w in ws.values())
    holder = api.Session(prog, 0, executor=api.SimulatorExecutor())
    holder.load(ws)
    del ws
    tplan = prog.compile_train(0, num_microbatches=DIST_PP_MICRO)
    fetches = [tplan.loss_name] + [tplan.grad_map[t.name]
                                   for t in tplan.graph.parameters()]
    states = microbatch_states(api, tplan, feeds, holder.weights)
    sched = tplan.schedule(DIST_PP_MICRO, "interleaved")
    out = dict(params=int(n_params), ticks=len(sched.ticks),
               v=tplan.virtual_stages_per_device,
               setup_s=time.perf_counter() - t0, runs={})
    launch = fa.flash_attention
    shapes = set()

    def recorded(q, k, v, **kw):     # the wrapper counts the launch
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return launch(q, k, v, **kw)
    fa.flash_attention = recorded
    got = {}
    try:
        for label, ex in (("async", api.DistAsyncExecutor(mesh)),
                          ("dist", api.DistExecutor(mesh))):
            lw = ex.lowered(tplan, fetches) if label == "async" else \
                ex.lowered(tplan, fetches, DIST_PP_MICRO)
            shapes.clear()
            # every rank starts the timed run together (rank 0 may still be
            # comparing (c) when the others arrive)
            dist.barrier()
            host = HostPeak()
            res, rec = timed_schedule(torch, fa, ex, tplan, sched, states,
                                      fetches, host)
            traffic = ex.traffic()
            rec.update(b1_shapes=sorted(shapes),
                       dispatches=lw.stats.kernel_dispatches,
                       plain_dispatches=lw.stats.ref_dispatches,
                       host_peak_gib=host.peak,
                       traffic={k: getattr(traffic, k) for k in (
                           "p2p_messages", "p2p_bytes", "collectives",
                           "staged_bytes")})
            if label == "async":
                rec["programs"] = sorted(f"{ph} {st}" for st, ph in
                                         lw.programs)
                rec["ticks"] = pipeline_ticks(lw)
            out["runs"][label] = rec
            if mesh.rank == 0:
                got[label] = res
            del res
    finally:
        fa.flash_attention = launch
    if mesh.rank != 0:
        return out
    t0 = time.perf_counter()
    bad = runs_differ(got["async"], got["dist"])
    out["bitwise"], out["differ"] = not bad, [list(x) for x in bad[:6]]
    del got["async"]
    # the stacked AsyncExecutor of phase 8 on the same program, feeds and
    # weights, its 4 virtual devices as rows on this rank's card
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    want = api.AsyncExecutor().run_schedule(tplan, sched, states, fetches)
    out["stacked_s"] = time.perf_counter() - t1
    lrel = [abs(a - b) / abs(b) for a, b in zip(
        out["runs"]["dist"]["loss"],
        [float(np.asarray(api.gather(r[tplan.loss_name]))) for r in want])]
    bad_grads, same = [], [lrel == [0.0] * len(lrel)]

    def pairs():
        for j, (a, b) in enumerate(zip(got["dist"], want)):
            for name in fetches[1:]:
                g = torch.from_numpy(flat_parts(a[name])).cuda()
                w = torch.from_numpy(flat_parts(b[name])).cuda()
                if not torch.allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL):
                    bad_grads.append(f"{j}:{name}")
                same.append(torch.equal(g, w))
                yield f"{j}:{name}", g, w
    worst = worst_normwise(pairs())
    out.update(stacked_loss_rel=lrel, stacked_bad=bad_grads[:6],
               stacked_normwise=worst, stacked_bitwise=all(same),
               compare_s=time.perf_counter() - t0)
    return out


def dist_rank_main(argv=None) -> int:
    """One rank of phase 10 (b), (c) and (d), started by
    ``runtime.harness.run_ranks``.  (b): phase 5's program, weights and
    feeds from seed 0, ``DIST_STEPS`` steps on ``DistExecutor``; its final
    weights, m and v against phase 5's (``--ref``), part by part (every
    replica), under the same annotations.  (c): (b)'s Session dropped and
    its card memory freed, the same blocks under the hsize=2
    ``selftest.hetero_block_strategy`` (dp2 on devices 0-1, tp2 on 2-3),
    ``DIST_STEPS`` steps; every part of its final state against the box it
    covers in phase 5's global value, formed from phase 5's parts once
    their replicas agree bitwise.  Every rank holds the whole state, so
    each compares a share of the leaves and rank 0 combines the shares.
    (d): (c)'s Session
    dropped and host memory trimmed, :func:`rank_pipeline`.  Prints one
    ``DIST_RANK_JSON {...}`` line."""
    import argparse
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.core.comm_resolve import resolve
    from repro_torch.core.plan import box_shape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_runtime_mesh
    from repro_torch.models.graph_block import block_program, build_block
    from repro_torch.runtime.selftest import (grad_plan_kinds,
                                              hetero_block_strategy)

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--ref", required=True)
    args = ap.parse_args(argv)
    mesh = make_runtime_mesh(backend=args.backend, device=args.device)
    cfg = get_config("qwen2-1.5b")
    ref = Path(args.ref)
    names = json.loads((ref / "names.json").read_text())
    out = dict(rank=mesh.rank, device=str(mesh.device))

    def share(tree):
        """This rank's share of a state tree's leaves to compare."""
        return [(n, st) for i, (n, st) in enumerate(sorted(tree.items()))
                if i % mesh.world == mesh.rank]

    def gathered(value) -> list:
        every = [None] * mesh.world
        dist.all_gather_object(every, value)
        return every

    # (b) phase 5's program: dp2 x tp2
    prog = block_program(cfg, batch=IR_BATCH, seq=IR_SEQ, n_layers=IR_LAYERS,
                         dp=2, tp=2, pp=1)
    sess, out["b"] = rank_steps(torch, fa, mesh, prog, cfg)
    steps = out["b"]["steps"]
    annots5 = {name: st.annot for name, st in sess.weights.items()}
    # every leaf's parts in device order on both sides, as phase 7
    # compares: a replica that drifted from its twin counts.  Each rank
    # first returns its cached card memory: the rank comparing the
    # embedding needs about 31 GiB of the card for it
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bitwise = [np.array_equal([s["loss"] for s in steps],
                              np.load(ref / "losses.npy"))]

    def pairs(key, got):
        for name, st in share(got):
            path, annot = names[f"{key}|{name}"]
            if repr(st.annot) != annot:
                fail(f"rank path: {key} {name} ends under "
                     f"{st.annot}, phase 5's under {annot}")
            have = torch.from_numpy(flat_parts(st)).cuda()
            want = torch.from_numpy(np.load(
                ref / path, mmap_mode="r")[...]).cuda()
            bitwise.append(torch.equal(have, want))
            yield name, have, want

    worst = {}
    for key in ("weights", "m", "v"):
        got = sess.weights if key == "weights" else sess.opt_state[key]
        # the key biases' m and v are left out, as phase 7 does
        worst[key] = worst_normwise(
            pairs(key, got), skip={n for n in got if key != "weights"
                                   and n.endswith("/bk")})
    every = gathered((worst, all(bitwise)))
    if mesh.rank == 0:
        out["b"].update(normwise={k: max(w[k] for w, _ in every)
                                  for k in worst},
                        bitwise=all(b for _, b in every),
                        compare_s=time.perf_counter() - t0)
    del sess, prog
    gc.collect()
    torch.cuda.empty_cache()
    out["b"]["host_left_gib"] = trim_host()

    # (c) the same blocks under hsize=2: dp2 on [0, 1], tp2 on [2, 3]
    g = api.Graph()
    build_block(g, cfg, batch=IR_BATCH, seq=IR_SEQ, n_layers=IR_LAYERS)
    prog = api.Program(g, [hetero_block_strategy(g)])
    kinds = grad_plan_kinds(prog.compile_train(0), resolve)
    sess, out["c"] = rank_steps(torch, fa, mesh, prog, cfg)
    out["c"]["grad_plans"] = {
        kind: sorted(w for w, k in kinds.items() if k[2] == kind)
        for kind in sorted({k[2] for k in kinds.values()})}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    replicas_bitwise, bitwise = [], []

    def global_pairs(key, got):
        """(name, every part of the hetero state in device order, the
        boxes they cover of phase 5's global value)."""
        for name, st in share(got):
            annot, shape = annots5[name], st.shape
            path, want_annot = names[f"{key}|{name}"]
            if repr(annot) != want_annot:
                fail(f"rank path: phase 5's {key} {name} under "
                     f"{want_annot}, not {annot}")
            flat = torch.from_numpy(np.load(
                ref / path, mmap_mode="r")[...]).cuda()
            full = torch.empty(shape, dtype=flat.dtype, device=flat.device)
            seen, at = {}, 0
            for dev in sorted(annot.devices):
                box = annot.device_box(dev, shape)
                n = int(np.prod(box_shape(box)))
                part = flat[at:at + n].view(box_shape(box))
                at += n
                if box in seen:
                    replicas_bitwise.append(torch.equal(part, seen[box]))
                    if not replicas_bitwise[-1]:
                        fail(f"rank path: phase 5's {key} {name} dev "
                             f"{dev} differs from its replica")
                else:
                    seen[box] = part
                    full[tuple(slice(a, b) for a, b in box)] = part
            del flat, seen
            have = torch.from_numpy(flat_parts(st)).cuda()
            want = torch.cat([
                full[tuple(slice(a, b) for a, b in
                           st.annot.device_box(dev, shape))].reshape(-1)
                for dev in sorted(st.parts)])
            del full
            bitwise.append(torch.equal(have, want))
            yield name, have, want

    worst = {}
    for key in ("weights", "m", "v"):
        got = sess.weights if key == "weights" else sess.opt_state[key]
        worst[key] = worst_normwise(
            global_pairs(key, got), skip={n for n in got if key !=
                                          "weights" and n.endswith("/bk")})
    every = gathered((worst, all(bitwise), len(replicas_bitwise)))
    if mesh.rank == 0:
        out["c"].update(normwise={k: max(w[k] for w, _, _ in every)
                                  for k in worst},
                        bitwise=all(b for _, b, _ in every),
                        replicas_checked=sum(n for _, _, n in every),
                        compare_s=time.perf_counter() - t0)
    del sess, prog, g
    gc.collect()
    torch.cuda.empty_cache()
    out["c"]["host_left_gib"] = trim_host()

    # (d) the blocks under tp2 x pp2: a real pipeline across the ranks
    out["d"] = rank_pipeline(torch, fa, mesh, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["d"]["host_left_gib"] = trim_host()

    # (e) one DeepSeek-V2 MoE layer expert-parallel over the ranks
    from repro_torch.launch import moe_ep
    out["e"] = moe_ep.run(mesh, moe_ep.parse([
        "--arch", EP_ARCH, "--tokens", str(EP_TOKENS), "--data",
        str(EP_MESH[0]), "--model", str(EP_MESH[1])]))
    gc.collect()
    torch.cuda.empty_cache()
    print("DIST_RANK_JSON " + json.dumps(out), flush=True)
    return 0


def rank_reports(procs, tag) -> list[dict]:
    """Each rank's ``<tag> {...}`` line, by rank."""
    out = []
    for p in procs:
        line = [x for x in p.stdout.splitlines() if x.startswith(tag + " ")]
        if len(line) != 1:
            fail(f"a rank printed {len(line)} {tag} lines:\n{p.stdout[-2000:]}")
        out.append(json.loads(line[0].split(" ", 1)[1]))
    return out


def print_rank_run(r, run):
    """One rank's line for run ``run`` (``"b"`` or ``"c"``)."""
    x = r[run]
    parts = x["steps"][-1]
    print(f"  ({run}) rank {r['rank']} on {r['device']}: setup "
          f"{x['setup_s']:.1f} s; steps " + ", ".join(
              f"{s['wall_s'] * 1e3:.0f}" for s in x["steps"])
          + f" ms; B1 launches a step {[s['launches'] for s in x['steps']]}"
          f" (the lowered graph dispatches {x['dispatches']}; at q, k "
          f"{x['b1_shapes']}); peak memory {x['peak_gib']:.2f} GiB on the "
          f"card; the Session's numpy weights, gradients, m and v "
          f"{x['host_state_gib']:.2f} GiB on the host (the process's peak "
          f"{x['host_peak_gib']:.2f} GiB"
          + (f", {x['host_left_gib']:.2f} GiB left once the Session is "
             f"dropped" if "host_left_gib" in x else "")
          + f"); step {DIST_STEPS}: "
          f"pack {parts['pack'] * 1e3:.1f} ms, compute "
          f"{parts['compute'] * 1e3:.1f} ms (B1 "
          f"{parts['attention'] * 1e3:.2f}), comm "
          f"{parts['comm'] * 1e3:.1f} ms (host staging "
          f"{parts['staging'] * 1e3:.1f}, exchanges "
          f"{parts['collective'] * 1e3:.1f}), fetch "
          f"{parts['fetch'] * 1e3:.1f} ms, host AdamW "
          f"{parts['adamw_s'] * 1e3:.1f} ms; comm over the run "
          f"{x['comm']['p2p_messages']} messages, "
          f"{x['comm']['p2p_bytes'] / 1e6:.1f} MB, "
          f"{x['comm']['collectives']} collectives, "
          f"{x['comm']['staged_bytes'] / 1e6:.1f} MB staged (plans: "
          f"{x['comm']['stages']} stages, "
          f"{x['comm']['uniform_reduce_stages']} uniform reduce, "
          f"{x['comm']['uniform_copy_stages']} uniform copy, "
          f"{x['comm']['copy_pairs']} pairs in "
          f"{x['comm']['permute_rounds']} rounds, "
          f"{x['comm']['grouped_reduces']} of "
          f"{x['comm']['reduce_groups']} reduce groups on subgroup "
          f"collectives); fetch {x['fetch']['staged_bytes'] / 1e6:.1f} MB "
          f"staged")


def check_rank_run(ranks, run, what, ir_losses, want_shapes):
    """(b) or (c) against phase 5's run: B1 launches (one a layer a step
    on every rank, none on the plain version) at ``want_shapes[rank]``,
    the ranks' losses equal, losses within LOSS_RTOL of phase 5's and the
    state within phase 7's limits.  Returns the losses and their relative
    differences."""
    per_rank = [[s["launches"] for s in r[run]["steps"]] for r in ranks]
    launches = sum(r[run]["launches"] for r in ranks)
    want = DIST_RANKS * IR_LAYERS * DIST_STEPS
    if launches != want or any(p != [IR_LAYERS] * DIST_STEPS
                               for p in per_rank) \
            or any(r[run]["plain_dispatches"] for r in ranks):
        fail(f"{what}: B1 launches {per_rank}, expected {IR_LAYERS} a step "
             f"on every rank ({want} in all) and no plain dispatch")
    got = [sorted(tuple(map(tuple, x)) for x in r[run]["b1_shapes"])
           for r in ranks]
    if got != [[s] for s in want_shapes]:
        fail(f"{what}: B1 at q, k shapes {got}, expected "
             f"{[[s] for s in want_shapes]}")
    losses = [s["loss"] for s in ranks[0][run]["steps"]]
    if any([s["loss"] for s in r[run]["steps"]] != losses for r in ranks):
        fail(f"{what}: the ranks' losses differ")
    lrel = [abs(a - b) / abs(b) for a, b in zip(losses, ir_losses)]
    limits = {"weights": TRAIN_PARAM_NORMWISE, "m": TRAIN_STATE_NORMWISE,
              "v": TRAIN_STATE_NORMWISE}
    x = ranks[0][run]
    worst = x["normwise"]
    print(f"  ({run}) losses {losses} vs phase 5's {list(ir_losses)} (rel "
          + ", ".join(f"{e:.1e}" for e in lrel) + f"; rtol {LOSS_RTOL:.0e})"
          f"; after step {DIST_STEPS} against phase 5's run (normwise, every"
          f" part; key biases' m and v left out): " + ", ".join(
              f"{k} {e:.2e} ({n}; limit {limits[k]:.0e})"
              for k, (e, n) in worst.items())
          + f"; {'bitwise' if x['bitwise'] else 'not bitwise'} (compare "
          f"{x['compare_s']:.1f} s"
          + (f", {x['replicas_checked']} phase-5 replicas bitwise their "
             f"twins" if "replicas_checked" in x else "") + ")")
    if max(lrel) > LOSS_RTOL or \
            any(e > limits[k] for k, (e, _) in worst.items()):
        fail(f"{what}: drifted from phase 5's run")
    return losses, lrel


def check_pipeline(ranks, total_mem):
    """(d): each rank's split, traffic, peaks and ticks; B1 once a
    microbatch on every rank at q (2, 6, 512, 128) in both runs, none
    plain; the ranks' losses equal; rank 0's checks (the two rank
    executors bitwise, the stacked run within phase 5's limits); the four
    ranks' peaks under the card's memory and the host's 96 GiB.  Returns
    the overlap on ranks and the launches."""
    hd, mb = 128, IR_BATCH // DIST_PP_MICRO
    want_shape = [[[mb, 6, IR_SEQ, hd], [mb, 1, IR_SEQ, hd]]]
    d0 = ranks[0]["d"]
    print(f"  (d) phase 5's blocks (q/k/v biases left out) under tp2 x pp2, "
          f"{d0['params'] / 1e6:.1f} M parameters, one interleaved 1F1B step "
          f"(v={d0['v']}, {d0['ticks']} ticks) of {DIST_PP_MICRO} "
          f"microbatches of {mb} x {IR_SEQ} on DistAsyncExecutor, then "
          f"DistExecutor; setup {d0['setup_s']:.1f} s a rank")
    launches = 0
    for r in ranks:
        x = r["d"]
        for label in ("async", "dist"):
            run = x["runs"][label]
            launches += run["b1_launches"]
            tr, t = run["traffic"], run["parts"]
            print(f"    rank {r['rank']} {label}: wall {run['wall_s']:.3f} s "
                  f"= pack {run['pack_s']:.3f} + dispatch loop "
                  f"{run['loop_s']:.3f} (compute {t['compute']:.3f}, comm "
                  f"{t['comm']:.3f}: staging {t['staging']:.3f}, "
                  f"exchanges {t['collective']:.3f}) + fetch "
                  f"{run['fetch_s']:.3f} s; B1 {run['b1_launches']} at "
                  f"{run['b1_shapes']} (dispatches {run['dispatches']}); "
                  f"{tr['p2p_messages']} messages, {tr['p2p_bytes'] / 1e6:.1f}"
                  f" MB, {tr['collectives']} collectives, "
                  f"{tr['staged_bytes'] / 1e6:.1f} MB staged; card peak "
                  f"{run['peak_gib']:.2f} GiB, host peak "
                  f"{run['host_peak_gib']:.2f} GiB")
            if run["b1_launches"] != DIST_PP_MICRO or \
                    run["dispatches"] != 1 \
                    or run["plain_dispatches"] or \
                    run["b1_shapes"] != want_shape:
                fail(f"(d) rank {r['rank']} {label}: B1 launched "
                     f"{run['b1_launches']} times at {run['b1_shapes']} "
                     f"(dispatches {run['dispatches']}, plain "
                     f"{run['plain_dispatches']}); expected "
                     f"{DIST_PP_MICRO} at {want_shape}, none plain")
        ticks = x["runs"]["async"]["ticks"]
        print(f"    rank {r['rank']} programs {x['runs']['async']['programs']}"
              f"; ticks (vstage mb phase: device ms from its first tick) "
              + "; ".join(f"{st} {mb} {ph}: {a:.1f}..{b:.1f}"
                          for st, mb, ph, a, b in ticks))
    losses = d0["runs"]["async"]["loss"]
    if any(r["d"]["runs"][label]["loss"] != losses for r in ranks
           for label in ("async", "dist")) or not all(
               math.isfinite(v) for v in losses):
        fail(f"(d): the ranks' losses differ or are not finite: {losses}")
    loops = {label: [r["d"]["runs"][label]["loop_s"] for r in ranks]
             for label in ("async", "dist")}
    overlap = 1 - max(loops["async"]) / max(loops["dist"])
    print(f"    overlap on ranks 1 - async loop / DistExecutor loop (the "
          f"slowest rank's) = 1 - {max(loops['async']):.3f} / "
          f"{max(loops['dist']):.3f} = {overlap:.4f}; by rank "
          + ", ".join(f"{1 - a / b:.4f}" for a, b in zip(loops["async"],
                                                        loops["dist"])))
    err, name = d0["stacked_normwise"]
    print(f"    losses {losses}; the two rank executors "
          f"{'bitwise' if d0['bitwise'] else 'differ at ' + str(d0['differ'])}"
          f"; against the stacked AsyncExecutor: loss rel "
          + ", ".join(f"{e:.1e}" for e in d0["stacked_loss_rel"])
          + f" (rtol {LOSS_RTOL:.0e}), gradients outside atol {GRAD_ATOL:.0e}"
          f" rtol {GRAD_RTOL:.0e}: {d0['stacked_bad'] or 'none'}, worst "
          f"normwise {err:.2e} ({name}; limit {GRAD_NORM_RTOL:.0e}); "
          f"{'bitwise' if d0['stacked_bitwise'] else 'not bitwise'} "
          f"(the stacked run {d0['stacked_s']:.1f} s, with the comparisons "
          f"{d0['compare_s']:.1f} s)")
    if not d0["bitwise"]:
        fail(f"(d): DistAsyncExecutor differs from DistExecutor at "
             f"{d0['differ']}")
    if max(d0["stacked_loss_rel"]) > LOSS_RTOL or d0["stacked_bad"] or \
            err > GRAD_NORM_RTOL:
        fail("(d): the rank pipeline disagrees with the stacked "
             "AsyncExecutor")
    card = sum(max(r["d"]["runs"][lb]["peak_gib"] for lb in ("async", "dist"))
               for r in ranks)
    host = sum(max(r["d"]["runs"][lb]["host_peak_gib"]
                   for lb in ("async", "dist")) for r in ranks)
    print(f"    four ranks' peaks summed: card {card:.2f} GiB of "
          f"{total_mem / 2**30:.2f}, host {host:.2f} GiB of 96")
    if card * 2**30 >= total_mem or host >= 96:
        fail(f"(d): peaks card {card:.2f} GiB, host {host:.2f} GiB")
    return overlap, launches


def phase_dist(torch, fa, ref, ref_state, ir_losses, ep_layer):
    """Phase 10: ranks sharing the card.  (a) The selftest at
    ``DIST_SWEEP`` ranks over gloo (the comm cases, and at 4 ranks the api
    cases too), each case bitwise against the port's simulator in every
    rank; NCCL where there are GPUs enough.  (b) Phase 5's program on
    ``DIST_RANKS`` ranks through ``DistExecutor`` and (c) the same blocks
    under the hsize=2 dp2|tp2 strategy, in one launch, each held to phase
    5's run under phase 7's limits.  Returns B1's launches and timings on
    this path and the phase's numbers."""
    from repro_torch.runtime.harness import RankError, run_ranks

    def ranks_run(*a, **kw):
        try:
            return run_ranks(*a, **kw)
        except RankError as e:
            tails = "\n".join(f"rank {i}: {p.stdout[-1500:]}{p.stderr[-3000:]}"
                              for i, p in enumerate(e.outputs))
            fail(f"{e}\n{tails}")

    print("== phase 10: ranks sharing the card (torch.distributed, gloo, "
          "every payload staged through host memory)")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    sweep = {}
    for n, cases in DIST_SWEEP.items():
        t0 = time.perf_counter()
        procs = ranks_run("repro_torch.runtime.selftest", n, backend="gloo",
                          device="cuda", timeout=DIST_SWEEP_TIMEOUT,
                          extra_args=["--cases", cases])
        rep = rank_reports(procs[:1], "RUNTIME_SELFTEST_JSON")[0]
        wall = time.perf_counter() - t0
        bad = [k for k, c in rep["cases"].items() if not c["ok"]]
        print(f"  selftest ({cases}) at {n} ranks on {rep['device']} over "
              f"{rep['backend']}: {len(rep['cases'])} cases, "
              f"{'all bitwise the simulator' if not bad else bad} "
              f"({wall:.1f} s); per case, over the ranks: p2p messages / "
              f"bytes, collectives, staged host bytes (a switch's "
              f"migrations are not counted)")
        for key, c in rep["cases"].items():
            if "p2p_messages" in c:
                print(f"    {key:26s} {c['p2p_messages']:4d} / "
                      f"{c['p2p_bytes']:7d} B, {c['collectives']:4d}, "
                      f"{c['staged_bytes']:7d} B"
                      + (f"; gradient plans "
                         f"{sorted(set(c['grad_comms'].values()))}"
                         if "grad_comms" in c else "")
                      + (f"; {c['kinds']}" if "kinds" in c else "")
                      + (f"; winner {c['winner']}, agreement "
                         f"{c['agreement']:.2f}, {c['ranks_agree']} ranks "
                         f"agree" if "winner" in c else "")
                      + (f"; channels {c['channel_kinds']}"
                         if "channel_kinds" in c else ""))
            else:
                print(f"    {key:26s} ok")
        if bad or not rep["ok"] or rep["device"] != "cuda":
            fail(f"rank selftest at {n} ranks: {bad}")
        sweep[n] = {"cases": len(rep["cases"]), "groups": cases,
                    "wall_s": wall,
                    "per_case": {k: {f: c.get(f) for f in (
                        "p2p_messages", "p2p_bytes", "collectives",
                        "staged_bytes")} for k, c in rep["cases"].items()}}
    count = torch.cuda.device_count()
    if count >= 2:
        procs = ranks_run("repro_torch.runtime.selftest", 2, backend="nccl",
                          device="cuda", timeout=DIST_SWEEP_TIMEOUT,
                          extra_args=["--cases", "comm"])
        rep = rank_reports(procs[:1], "RUNTIME_SELFTEST_JSON")[0]
        if not rep["ok"]:
            fail("rank sweep over NCCL")
        sweep["nccl"] = {"cases": len(rep["cases"])}
        print(f"  NCCL at 2 ranks: {len(rep['cases'])} cases bitwise")
    else:
        print(f"  NCCL not run: {count} visible GPU; NCCL refuses two ranks "
              f"on one GPU, so the nccl backend needs a GPU per rank")

    print(f"  Qwen2-1.5B full width, {IR_LAYERS} layers, batch {IR_BATCH}, "
          f"seq {IR_SEQ}, on {DIST_RANKS} ranks sharing the card "
          f"(DistExecutor, gloo), {DIST_STEPS} steps under (b) dp2 x tp2, "
          f"then (c) the hsize=2 dp2|tp2 strategy (dp2 on devices 0-1, tp2 "
          f"on 2-3, each on half the batch), then (d) one pipelined step "
          f"under tp2 x pp2 in the same launch; each rank rebuilds phase "
          f"5's weights and feeds from seed 0")
    print(f"  this process holds {trim_host():.2f} GiB of host memory "
          f"before the launch")
    t0 = time.perf_counter()
    procs = ranks_run(
        "import sys, chip_smoke; sys.exit(chip_smoke.dist_rank_main())",
        DIST_RANKS, backend="gloo", device="cuda", timeout=DIST_RUN_TIMEOUT,
        extra_args=["--ref", ref_state])
    run_s = time.perf_counter() - t0
    ranks = rank_reports(procs, "DIST_RANK_JSON")
    for run in ("b", "c"):
        for r in ranks:
            print_rank_run(r, run)
    plans = ranks[0]["c"]["grad_plans"]
    print("  (c) gradient plans: " + "; ".join(
        f"{kind}: {len(ws)} ({', '.join(ws[:3])}"
        f"{', ...' if len(ws) > 3 else ''})" for kind, ws in plans.items()))
    if not any("SplitAR" in kind for kind in plans):
        fail(f"(c): no gradient resolves to a SplitAR: {sorted(plans)}")
    # B1's q and k on a rank: half the batch and half the heads under
    # tp2 ((b), and (c)'s ranks 2-3); a dp2 row of half the batch with all
    # the heads ((c)'s ranks 0-1)
    hd = 128
    tp = ((IR_BATCH // 2, 6, IR_SEQ, hd), (IR_BATCH // 2, 1, IR_SEQ, hd))
    dp = ((IR_BATCH // 4, 12, IR_SEQ, hd), (IR_BATCH // 4, 2, IR_SEQ, hd))
    b_losses, b_rel = check_rank_run(ranks, "b", "rank path (b)", ir_losses,
                                     [tp] * DIST_RANKS)
    c_losses, c_rel = check_rank_run(ranks, "c", "rank path (c)", ir_losses,
                                     [dp, dp, tp, tp])
    overlap, d_launches = check_pipeline(
        ranks, torch.cuda.get_device_properties(0).total_memory)
    ep = check_ep(ranks, ep_layer)
    print(f"  ranks' run {run_s:.1f} s")
    # B1 at this path's shapes: (b)'s and (c)'s tp2 ranks take q
    # (2, 6, 512, 128); (c)'s dp2 ranks q (1, 12, 512, 128)
    shape = (f"B{IR_BATCH // 2} H6 K1 S{IR_SEQ} D128 causal fp32 (graph-IR "
             f"Qwen2-1.5B on {DIST_RANKS} ranks sharing the card: a rank's "
             f"row under dp2 x tp2, and a tp2 rank of dp2|tp2)")
    timing = b1_at_shape(torch, fa, ref, shape, IR_BATCH // 2, 6, 1,
                         IR_SEQ, 128)
    timing["launches"] = sum(r["b"]["launches"] for r in ranks) + sum(
        r["c"]["launches"] for r in ranks if r["rank"] >= 2)
    shape = (f"B{IR_BATCH // 4} H12 K2 S{IR_SEQ} D128 causal fp32 (graph-IR "
             f"Qwen2-1.5B under dp2|tp2 on {DIST_RANKS} ranks sharing the "
             f"card: a dp2 rank's row)")
    timing_dp = b1_at_shape(torch, fa, ref, shape, IR_BATCH // 4, 12, 2,
                            IR_SEQ, 128)
    timing_dp["launches"] = sum(r["c"]["launches"] for r in ranks
                                if r["rank"] < 2)
    mb = IR_BATCH // DIST_PP_MICRO
    shape = (f"B{mb} H6 K1 S{IR_SEQ} D128 causal fp32 (graph-IR Qwen2-1.5B "
             f"under tp2 x pp2 on {DIST_RANKS} ranks sharing the card: a "
             f"rank's microbatch, DistAsyncExecutor and DistExecutor)")
    timing_pp = b1_at_shape(torch, fa, ref, shape, mb, 6, 1, IR_SEQ, 128)
    timing_pp["launches"] = d_launches
    t_phase = time.perf_counter() - t_phase
    print(f"  phase 10: {t_phase:.1f} s")
    return [timing, timing_dp, timing_pp], {
        "sweep": sweep, "ranks": ranks, "losses": {"b": b_losses,
                                                   "c": c_losses},
        "loss_rel": {"b": b_rel, "c": c_rel}, "overlap_d": overlap,
        "ep_e": ep, "run_s": run_s, "phase_s": t_phase}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import policy, ref
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import ssd_scan as sk

    # phase 5's host-side reference starts first: it needs no card and is
    # the longest thing that runs beside phases 1-4
    t_start = time.perf_counter()
    sim_dir = tempfile.TemporaryDirectory(prefix="phase5-sim-")
    sim_ref = SimulatorReference(sim_dir.name)

    print("== phase 1: device")
    card = card_line()
    print(card)
    resolve_device("cuda")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s); TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print("== phase 2: build")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    reports = _build.build(sources)
    for name in sources:
        _build.load(name)
    print(f"  built {sorted(reports)} of {sources} in "
          f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for name, log in reports.items():
        for fn, regs, st, ld in ptxas_report(log):
            print(f"  {name}: {fn}: {regs} registers, spill stores {st} B, "
                  f"loads {ld} B")
            if st or ld:
                spills.append(f"{name}: {fn}")
    print(f"  ptxas spills: {spills or 'none'}")
    if any(s.startswith("rglru_scan:") for s in spills):
        fail("the RG-LRU kernel spills registers")
    if any(s.startswith("flash_attention:") for s in spills):
        fail("a flash-attention kernel spills registers")

    print("== phase 3: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fa_worst, fa_t = phase_attention(torch, fa, ref, gen)
    ssd_worst, ssd_t = phase_ssd(torch, sk, ref, gen,
                                 ptxas_report(reports.get("ssd_scan", "")))
    rg_worst, rg_t = phase_rglru(torch, rk, ref, gen)

    served = {arch: phase_serve(torch, policy, arch) for arch in ARCHS}
    paths = {arch: run[0] for arch, run in served.items()}
    bf16_serve = {arch: run[1] for arch, run in served.items()}
    total = {k: sum(p[k] + bf16_serve[a]["launches"][k]
                    for a, p in paths.items()) for k in paths[ARCHS[0]]}
    t_ir = time.perf_counter()
    print(f"  phases 1-4: {t_ir - t_start:.1f} s")
    ir, ir_run = phase_graph_ir(torch, fa, ref, sim_ref)
    print(f"  phase 5: {time.perf_counter() - t_ir:.1f} s")
    sim_dir.cleanup()
    # phase 11's dry run starts once phase 5's reference child has ended
    # (the two would share the host's cores), and ends before phase 10
    dry_dir = tempfile.TemporaryDirectory(prefix="phase11-")
    dry_child = DryRunChild(dry_dir.name, gpu_name_from_smi())
    total["flash"] += ir["launches"]
    kmods = {"flash": fa, "ssd": sk, "rglru": rk}
    stage = training_stage(torch, families=())
    train = phase_train_all(torch, policy, kmods, stage)
    stage.close()
    for t in train.values():
        for k, n in t["launches"].items():
            total[k] += n
    elastic = phase_elastic(torch, fa, ir_run)
    total["flash"] += elastic["launches"]
    ref_dir = tempfile.TemporaryDirectory(prefix="phase5-")
    ref_state = dist_reference(ir_run, ref_dir.name)
    ir_losses = ir_run["losses"][:DIST_STEPS]
    del ir_run
    pp_b1, pipeline = phase_async(torch, fa, ref)
    total["flash"] += pp_b1["launches"]
    fams, fam_b1, fam_s = phase_families(torch, policy, fa, ref)
    stage = training_stage(torch, archs=())
    famtrain, famtrain_s = phase_families_train(torch, policy, kmods, stage)
    stage.close()
    for run in (*fams.values(), *famtrain.values()):
        for k, n in run["launches"].items():
            total[k] += n
    production = phase_production_dryrun(dry_child, train, famtrain)
    dry_dir.cleanup()
    with ref_dir:
        dist_b1, ranks = phase_dist(torch, fa, ref, ref_state, ir_losses,
                                    production["ep_layer"])
    total["flash"] += sum(t["launches"] for t in dist_b1)

    def training(kind):
        """Each training config's launches a step and plain recompute
        (phases 6 and 12)."""
        return {arch: {"launches_per_step": t["launches_per_step"][kind],
                       "launches": t["launches"][kind],
                       "plain_backward_ms": t["plain_backward_ms"][kind]}
                for arch, t in (*train.items(), *famtrain.items())
                if t["launches_per_step"][kind]}

    def entry(name, source, replaces, launches, worst, t, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                **extra}

    csrc = "src/repro_torch/csrc/"
    flash_shapes = [
        {"shape": "B4 H12 K2 S512 D128 causal fp32 (Qwen2-1.5B prefill)",
         "launches": paths["qwen2-1.5b"]["flash"], **fa_t[(128, "float32")]},
        {"shape": "B4 H16 K1 S512 D256 causal window 2048 fp32 "
                  "(RecurrentGemma-9B prefill)",
         "launches": paths["recurrentgemma-9b"]["flash"],
         **fa_t[(256, "float32")]},
        ir,
        {**ir, "shape": "B8 H6 K1 S512 D128 causal fp32 (elastic Qwen2-1.5B "
                        "shrink/grow: dp2 x tp2, then tp2; the rows folded "
                        "into the batch; times at phase 5's shape)",
         "launches": elastic["launches"]},
        pp_b1,
        {"shape": "B4 H12 K2 S512 D128 causal bf16 (tensor cores; "
                  "Qwen2-1.5B bf16 prefill)",
         "launches": bf16_serve["qwen2-1.5b"]["launches"]["flash"],
         **fa_t[(128, "bfloat16")]},
        {"shape": "B4 H16 K1 S512 D256 causal window 2048 bf16 (tensor "
                  "cores; RecurrentGemma-9B bf16 prefill)",
         "launches": bf16_serve["recurrentgemma-9b"]["launches"]["flash"],
         **fa_t[(256, "bfloat16")]},
        {"shape": "B4 H128 K128 S512 D192/128 causal fp32 (DeepSeek-V2 MLA "
                  "prefill)",
         "launches": fams["deepseek-v2-236b"]["launches"]["flash"],
         **fa_t[(192, "float32")]},
        {"shape": "B4 H128 K128 S512 D192/128 causal bf16 (tensor cores)",
         "launches": 0, **fa_t[(192, "bfloat16")]},
        {"shape": "B4 H20 K20 S384 D64 causal bf16 (tensor cores; "
                  "Whisper large-v3's decoder self-attention)",
         "launches": 0, **fa_t[(64, "bfloat16")]},
        *({**fam_b1[arch], "launches": fams[arch]["launches"]["flash"]}
          for arch in fam_b1),
        # phase 12 trains at the prefill shapes of phases 3 and 9 (a
        # microbatch is 4 sequences); these launches are its own
        {**fa_t[(192, "float32")],
         "shape": "B4 H128 K128 S512 D192/128 causal fp32 (DeepSeek-V2 MLA "
                  "training, phase 12)",
         "launches": famtrain["deepseek-v2-236b"]["launches"]["flash"]},
        *({**fam_b1[arch], "shape": fam_b1[arch]["shape"].replace(
            "prefill)", "training, phase 12)"),
           "launches": famtrain[arch]["launches"]["flash"]}
          for arch in fam_b1),
        *dist_b1]
    kernels = [
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:114", total["flash"],
              fa_worst, fa_t[(128, "float32")],
              cuda_launches_per_call=fa_t[(128, "float32")][
                  "cuda_launches_per_call"],
              shapes=flash_shapes, training=training("flash")),
        entry("ssd_scan", csrc + "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:92", total["ssd"], ssd_worst,
              ssd_t["float32"], kernel_ms=ssd_t["float32"]["kernel_ms"],
              cuda_launches_per_call=ssd_t["float32"][
                  "cuda_launches_per_call"],
              shape="b4 s512 h32 p64 n128 chunk256 fp32 "
                    "(Mamba2-370M prefill)",
              bf16={**ssd_t["bfloat16"], "launches": bf16_serve[
                  "mamba2-370m"]["launches"]["ssd"],
                  "shape": "the same in bf16 (Mamba2-370M bf16 prefill; "
                           "tensor cores)"},
              training=training("ssd")),
        entry("rglru_scan", csrc + "rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:70", total["rglru"], rg_worst,
              rg_t["float32"], cuda_launches_per_call=rg_t["float32"][
                  "cuda_launches_per_call"],
              shape="b4 s512 w4096 fp32 (RecurrentGemma-9B prefill)",
              bf16={**rg_t["bfloat16"], "launches": bf16_serve[
                  "recurrentgemma-9b"]["launches"]["rglru"]},
              training=training("rglru")),
    ]
    print("serve_bf16: " + json.dumps(bf16_serve))
    print("training: " + json.dumps({
        arch: {k: v for k, v in t.items() if k != "learn_losses"}
        for arch, t in train.items()}))
    print("elastic: " + json.dumps(elastic))
    print("pipeline: " + json.dumps(pipeline))
    print("families: " + json.dumps({
        "runs": fams, "phase_s": fam_s,
        "training": famtrain, "training_phase_s": famtrain_s}))
    print("ranks: " + json.dumps(ranks))
    print("production: " + json.dumps(production))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
