"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, builds the kernels from
``pathtrace_tpu_torch/csrc/`` with nvcc (one nvcc a source, all at once),
and runs twenty-five phases, each printing its own lines; any failure raises
and exits non-zero.

1. Environment: the card's name and power limit, torch's CUDA version, nvcc
   and Triton versions.
2. A clean build of the five kernel libraries (trace, grad, NEE grad, the
   all-parameter backward and the f32 probes), timed.
3. The trace kernel against its plain PyTorch version on the card, at
   128x64 and 4 spp with row and sample offsets, for diffuse, NEE and glossy
   in the 14-, 22- and 3-channel modes. Every channel is held to the rules
   of ``trace_kernel.agreement``: albedo equal on >= 99.9% of pixels;
   colour (1e-3), normal (2e-6), depth (rtol 5e-4) and each variance or
   Welford (n, mean, M2) channel (1e-3 of its range) out of tolerance on
   <= 1%; and beyond those rules, max |kernel - plain| must be 0: built
   without contraction, the kernel is its plain version to the bit.
4. The render path: the CLI renders the default frame (512x512, 4 spp, 5
   bounces) on cuda:0 through the kernel; the EXR and 8 bitmaps are read
   back and all 14 channels are held against the plain version, same rules
   (to the bit).
5. Timing: median of 10 CUDA-event-timed runs after warm-up, kernel and
   plain version, at 512x512x4 spp and 512x512x32 spp (the plain version at
   32 spp, ~1 s a call, 2 runs a turn), in turns plain, kernel, kernel,
   plain; then the colour sums
   of the NEE and glossy inverse steps (256x256x16 NEE, 256x256x8 glossy) by
   CUDA events and by ``torch.profiler`` (the kernel alone), each beside its
   bound (``color_nee``, ``color_glossy`` operations a segment).
6. The grad kernel's three modes against their plain versions on the card
   at 128x64 and 4 spp (the dump also at row offset 16 and sample offset
   5), under ``grad_kernel.agreement``: gradient sums and loss within rtol
   1e-4 plus 1e-8 of the largest; mean colour under the colour rule above;
   accumulators off by more than 1e-3 of their channel's range on <= 1% of
   pixels. Then the modes against each other (fused = dump + contraction =
   replay, same rule as the sums), and two fused launches that must give
   the same bits.
7. The gradient paths at full size, each with every launch count set to 0
   just before and read just after: (a) the albedo recovery of
   scripts/inverse_demo.py (256x256, 8 spp a step, target at 64 spp, 400
   Adam steps at lr 2e-2, all 9 albedos corrupted) through
   ``inverse.make_inverse_step`` as that script drives it, which must launch
   the dump kernel twice a step, keep every loss finite and end with the mean albedo error below
   half the corrupted one; (b) ``grad.render_loss_grads`` at 512x512x32
   spp through the fused kernel, whose loss must equal the mean squared
   error of the trace kernel's colour (rtol 1e-4); (c)
   ``grad_kernel.render_color_grads`` at the same frame, against the MSE
   cotangent, whose gradients must equal (b)'s under the sums rule.
8. Timing of the gradient kernels against their plain versions: fused at
   512x512x32 and 512x512x4 spp and replay at 512x512x32 (the kernel: median
   of 20 CUDA-event-timed runs after warm-up, in two turns; the plain
   versions, which take ~1 s a call at 32 spp: one run after one warm-up,
   in turns plain, kernel, kernel), the dump and
   the cross-estimator loss and gradients of one inverse step
   (``grad_kernel.cross_grads``, the step's own path) at 256x256x8, and the
   whole inverse step (kernel only); the dump also by ``torch.profiler``
   beside its CUDA-event time. The last kernel output of each line is
   held against the last plain one under phase 6's rules (fused: sums and
   colour; replay: sums; dump: colour and accumulators; cross-estimator:
   loss and gradients as sums), so the kernels are also checked at the main
   paths' shapes, where the second pass sums thousands of block partials.
   The kernels line's max_abs_err is the largest of phases 6 and 8.
9. The NEE grad kernel against its plain versions on the card at 128x64 and
   4 spp, also at row offset 16 and sample offset 5, under
   ``nee_grad_kernel.agreement``: every gradient sum within rtol 1e-4 plus
   1e-6 of the largest of its kind, colour under the colour rule. Then:
   the replay against the MSE cotangent equals fused (rtol 1e-4 plus 1e-4
   of the largest of the kind: another order of operations on sums that
   cancel); two fused launches give the same bits; the fused colour equals
   the trace kernel's NEE colour bit for bit; and a 32-spp replay, 160 adds
   a lane into a geometry sum kept in double, must equal its plain version
   to the bit: the lane pairs add in the plain version's order.
10. The NEE gradient path at full size, launch counts set to 0 before each
   part and read after: (a) ``grad.render_loss_grads`` at 512x512x32 spp
   with NEE: exactly one fused launch, loss equal to the MSE of the trace
   kernel's colour (rtol 1e-4), non-zero position, radius and camera
   gradients; (b) the geometry recovery of scripts/inverse_demo.py through
   ``inverse.make_inverse_step``: 256x256, 16 spp, NEE, 400 Adam steps,
   sphere 6 displaced by (6, -4, 8) and shrunk 20%, learning rates 0.5 and
   0.1 decaying to x0.02, gradients masked to sphere 6, target at 64 spp;
   every step must launch the trace kernel twice and the NEE replay twice.
   The case's target, radius and whole position error both below 70% of
   their start, is printed as MET or NOT MET and does not stop the run:
   along the view axis (z) this estimator, whose silhouette terms are
   zero, does not pull the sphere back, on the kernel route and on
   autograd through the wavefront alike (PERF.md). What stops the run: the
   radius error or the position error across the view (x, y) not below
   70% of its start, a masked sphere that moved, a non-finite loss, or a
   whole position error more than a quarter above its start (a recovery
   that diverges).
11. The probe kernel's two probes against their plain versions: all six
   modes at 1 chain and FMA and multiply at 8 chains on varied inputs for
   64 steps, then at the shapes of the readings: FMA and multiply at 8
   chains on 16.8 M elements for 8,192 steps, ``fma`` at 1 chain on 8,192
   elements for 1,048,576 steps (the other five modes there for 2,048
   steps); within 1e-6 of the largest value. The plain runs at full depth
   are timed: the kernels line's ``plain_ms`` is for the kernel's own
   work. Then the card's readings through
   ``roofline.measure_f32_peak`` and ``roofline.latency_probe``, then one
   line a kernel: time, launches
   on its main path, bound and share of it. A bound is traced segments
   (``roofline.count_segments``) x counted operations a segment (a
   multiply and an add count as two) over the card's published f32 peak,
   67 TFLOP/s with a fused multiply-add as two, or bytes over 3.35 TB/s,
   whichever gives more. ``bound_ms_unfused_measured`` is the same count
   over the multiply-only rate the probe measured in this run: the least
   time for a build without FMA contraction, which these kernels are. The
   latency probe is one dependent chain a thread, so its bound is the
   chain's 1,048,576 steps at an FMA's dependent-issue latency (4 cycles,
   Volta through Hopper, a published figure; phase 24 measures the card's)
   over the SM clock ``nvidia-smi`` reads as
   ``clocks.max.sm`` (``bound_model`` "latency" in the kernels line; its
   throughput bound beside it as ``bound_ms_throughput``).
12. Timing of the NEE grad kernel (fused and replay at 512x512x32, the
   cross-estimator and the whole NEE inverse step at 256x256x16) against
   the plain versions, each last kernel output held against the last plain
   one under phase 9's rules; the trace kernel's NEE colour pass beside
   them; and ``torch.profiler`` device times by kernel over 20 NEE inverse
   steps.

13. The all-parameter backward kernel (K4) against its plain version on the
   card at 128x64 and 4 spp, under ``nee_grad_kernel.agreement`` (every sum
   within rtol 1e-4 plus 1e-6 of the largest of its kind): diffuse and
   glossy, with and without NEE, against a colour cotangent, against
   cotangents in all ten channels (normal, albedo and depth included), and
   at row offset 16 and sample offset 2; two launches must give the same
   bits; one 32-spp launch; without NEE and colour-only the geometry and
   camera sums must be exactly 0; and on NEE diffuse with a colour-only
   cotangent K4 must equal the NEE kernel's replay bit for bit.
14. The glossy gradient paths at full width through the user entry points,
   launch counts set to 0 before each part and read after: (a)
   ``grad.render_loss_grads`` at 512x512x32 spp for glossy and for NEE
   glossy: exactly one colour-sum launch of the trace kernel and one K4
   launch each, loss and all gradients held against the plain route
   (``trace_plain`` colour, ``replay_plain``); (b)
   ``ad_grad_kernel.ad_loss_and_grads`` on the NEE diffuse frame of phase
   10 (a) beside the NEE kernel's fused mode: the same gradients within
   1e-4 of the largest of their kind; (c) the albedo recovery of phase 7
   (a) under the glossy BRDF for 100 Adam steps through
   ``inverse.make_inverse_step``: two trace and two K4 launches every step,
   the first three steps' losses (rtol 1e-2: the wavefront and the kernel
   send a few near-mirror paths different ways, and the cross-estimator is
   a small difference of products; 2.6e-3 was measured at step 1) and
   albedo gradients (rtol 2e-2 plus 2e-2 of the largest) equal to the
   autograd route's, every loss finite, and the mean albedo error lower at
   the end than at the start.
15. Timing of K4 (median of 20 CUDA-event-timed runs, the plain version
   once) at 512x512x32 for glossy, NEE glossy and NEE diffuse (the NEE
   kernel's replay beside it) and at 256x256x8, each last output held
   against the plain version's; the glossy inverse step, with
   ``torch.profiler`` device times by kernel over 20 steps.
16. The shared reverse sweep (``csrc/sweep.cuh``): resident blocks an
   SM, registers, shared and local bytes of every instance of the NEE
   kernel and of K4, at 8x8 and 16x16 threads (the default launch of every
   instance must keep more than 5 blocks resident and use no more local
   memory than its tape); the shading-only instances (a colour-only
   cotangent [3, h, W] without NEE) at 128x64 and 4 spp against the full
   ones with seven planes of zeros (all sums bit-equal, geometry and camera
   sums exactly 0), against the plain version (``nee_grad_kernel.agreement``)
   and launched twice (identical bits); the colour-only cotangent under NEE
   against the zero planes, and K4 on NEE diffuse against the NEE kernel's
   replay, bit for bit; a frame with an odd width, a ragged last block and
   a 5x5 block, whose last thread has no lane partner; the occupancy curve:
   the NEE replay at 512x512x32 and 256x256x16 with its dynamic shared memory
   padded so that 1, 2, ... blocks are resident; the colour-only instances
   timed at 512x512x32 and at the inverse steps' sizes (256x256x16 NEE,
   256x256x8 glossy): the shading-only ones and the NEE replay against their
   plain versions, each last output held against the plain version's, the
   NEE ones of K4 held to the bits of the full instance, which phase 15
   holds against its plain version at that size; and the NEE and glossy
   inverse steps' device time and idle share from phases 12 and 15.
17. The bit gate of the forward kernel and the product-chain gradient
   kernel: ``kernel_digests`` (sha256 of the bytes K1 writes in its three
   modes under the four configurations at phase 3's case and in its colour
   passes at the inverse steps' sizes, of K2's fused and dump outputs at
   256x256x8 and 512x512x32, of K5's sums at 512x512x32) must equal
   ``KERNEL_DIGESTS``, recorded from the thread-a-pixel kernels before their
   redesign; a mismatch names the nvcc that recorded them and this one.
18. The denoised frame and the interactive loop (the reference's second
   mode, SURVEY.md §3.2), with the denoiser's weights made in the process
   by ``models.init_model`` (seed 0) and written with
   ``train.save_checkpoint`` to a temporary directory; each part sets the
   trace kernel's launch count to 0 before it and reads it after: (a)
   ``cli.main(["-d", ...])`` renders and denoises the default frame
   (512x512, 4 spp) on cuda:0 through K1 and cuDNN (f32, TF32 off); the
   EXR's other channels must be the re-rendered frame's bits, and its
   denoised colour the same model's forward on the CPU on that buffer within
   1e-4; (b) a ``ProgressiveRenderer`` on the default device, batches of 4,
   8 and 20 spp at 512x512: three launches, bit-equal to the plain version's
   partials of the same batches merged, and equal to one 32-spp render
   within rtol/atol 1e-3; (c) a ``FrameStepper(progressive=True,
   denoising=True)``: 8 steps at 512x512x4 with a move between steps 4 and
   5, accumulating 4, 8, 16, 32 spp and again from 4, one launch a step,
   finite AOVs and uint8 frames; (d) ``cli.main(["-i", "--frames", "3",
   "-d", ...])`` writes 3 BMPs; (e) CUDA-event times (median of 20 after
   warm-up) of the CNN alone at 512x512 in f32 and in TF32, each beside its
   operation count (convolutions, a multiply-add as two) and the share of
   the published peak, of the render alone, of the denoised frame (render +
   CNN; ``torch.profiler``'s device time and K1's part of it beside it), and
   of one progressive ``FrameStepper.step`` after a move.
19. The denoiser's training path at the JAX training CLI's defaults (33
   poses at 256x256, 2 / 512 spp, 16 patches of 64x64 an image, the
   full-width CNN, batch 5), weights from ``models.init_model`` (seed 0):
   (a) one 512-spp ground-truth launch of K1 (rows 112-143 of pose 0, the
   22- and 14-channel modes) against its plain version under phase 3's
   rules, to the bit; then ``train.build_dataset`` and the validation pair
   with the launch count set to 0 before and read after (68 launches: two a
   pose and two for the validation pair); (b) three ``train_step``s on
   cuda:0 against the same code on the CPU from the same weights and
   batches: losses within rtol 1e-5, every weight, BN statistic and
   momentum buffer within 2e-2 of its tensor's largest value plus 1e-6, the
   update as a whole within 1e-3 of its norm; three ``simple_train_step``s
   (Adam): losses within rtol 1e-5, the update within 0.2 of its norm; (c)
   ``train.main`` for 4 epochs with a checkpoint and validation every 2:
   68 launches, the last epoch's loss below the first's, finite PSNRs,
   ``model_epoch.pt``, ``model_best.pt``, ``best.json``, ``metrics.jsonl``
   and the preview BMPs written; the checkpoint restores epoch 4 with its
   momentum buffers to the bit; from it, three steps of ``train_epoch``
   (the dataset on the card) against three of ``loop_epoch`` under (b)'s
   rules; ``--resume --epochs 1`` continues at epoch 5 on the loop route
   twice and on ``--scan-epochs`` once: the three epochs' weights, BatchNorm
   statistics and momentum buffers must be the same bits (the card's
   training step is deterministic: cuDNN's deterministic algorithms and the
   bilinear resize's matrix backward), and the scan route's update within
   0.5 of the loop's norm; then
   ``cli.main(["-d", "--checkpoint", ...])`` denoises a 512x512x4 frame with
   the trained weights; the native IO library's EXR and BMP against the
   Python codec where it builds; (d) CUDA-event times of a ``train_step``
   (median of 20) and of an epoch on each route (one after a warm-up), the step's
   device time and idle share by ``torch.profiler``, and its bound.
20. The ("tiles", "samples") grid of ``pathtrace_tpu_torch/parallel/`` with
   several ranks sharing the one card (gloo: NCCL refuses two ranks on one
   device), so the decomposition's correctness is shown, not scaling. The
   ranks start from ``parallel.launch`` after phase 2 built every library,
   run ``parallel.selfcheck.card_world`` and return what the parent
   compares; each rank sets its launch counts to 0 before the main path
   and returns them after, and the kernels line adds them up. (a) A world
   of 4 ranks renders the bench frame (512x512x32) on (4,1), (2,2) and
   (1,4): every rank holds the same frame, equal to ``render_channels`` on
   cuda:0 (means rtol/atol 1e-4, each variance channel scaled by its
   largest value to 2e-3; whether the bits matched is printed), and each
   rank's slab launch of K1 (partials) equals its plain version to the bit;
   (b) on (2,2), ``sharded_loss_grads`` at 512x512x8 for diffuse (K2 dump),
   NEE (K1 colour, K3 replay), glossy and NEE glossy (K1 colour, K4)
   against ``grad.render_loss_grads``: loss rtol 1e-5, each field rtol 1e-3
   plus 1e-4 of its largest entry; and each rank's backward launch at the
   grid's shapes, with the seed block and cotangent it was given
   (``shard.kernel_slab_launch``), against its plain version on cuda:0 on
   those inputs: the dump's colour and accumulators under phase 6's rules,
   the K3 and K4 blocks under phases 9 and 13's (whether the bits matched
   is printed); (c) a 1024x1024x4 frame rendered on (4,1), preprocessed
   and denoised as slabs by ``denoise_spatially_sharded`` and by
   ``denoise_fpn_sharded`` (full widths, weights and BatchNorm statistics
   of seeds 0, 1 and 2): the preprocessed slabs equal the whole frame's to
   the bit; the simple net's output equals the whole frame's within
   tests/test_spatial.py's rtol 1e-5 and atol 1e-5 times its largest
   output; for each FPN seed, the sharded output is within
   GRID_FPN_F64_LIMIT of the f64 forward of the same weights on cuda:0 and
   within GRID_FPN_WHOLE_LIMIT of the whole frame's f32 forward, with at
   most GRID_FPN_MAX_BEYOND outputs beyond tests/test_spatial.py's rtol
   1e-5 + atol 2e-5 (cuDNN picks its algorithms by shape, so the slabs'
   convolutions round unlike the whole frame's); a TF32 forward of the
   whole frame, the control, must break the f64 limit; (d) a world of 1
   rank on NCCL: the render and the NEE route against the single-device
   entry points; (e) ``dryrun_multichip(4)`` and
   ``scaling.main(["--json"])``, whose one-card record must carry a null
   gate. Times by CUDA events (10 turns after a warm-up): the sharded
   render at world 1 and the single-device render, called in turns in one
   loop (the grid's own cost: the median of the turns' differences, with
   their range), the render on the first 1, 2 and 4 ranks of the gloo
   world (labelled: not a scaling figure), and the sharded FPN at
   1024x1024. The dry run ends with ``train.dryrun_cnn_dp``, the CNN's
   split step, whose loss every rank must hold alike.
21. The denoiser trainer's batch data parallelism (``train.dp_sharding``;
   BatchNorm's statistics and the L1 mean over the whole batch, the
   gradients summed in one all-reduce): (a) ``train.build_dataset`` at 4
   poses of 256x256, 2 / 64 spp, 16 patches of 64x64 an image, through K1,
   the launch count set to 0 before and read after (8 launches; the kernels
   line adds them to K1's); (b) a world of 4 gloo ranks sharing cuda:0
   (``parallel.selfcheck.dp_world``) takes 3 ``train_step``s of the
   full-width CNN (``init_model`` seed 0) on batches of 8, 2 a rank, against
   3 steps on cuda:0 on the whole batches from the same weights: losses
   within rtol DP_LOSS_RTOL, the update of the weights and statistics and
   that of the momentum each within DP_UPDATE_L2 of its norm, and every
   rank's losses and state rank 0's to the bit; (c) one ``fit`` epoch on
   the ``--scan-epochs`` route in that world: the same history on every
   rank, the ranks' states bit-equal, one metrics record and a checkpoint of
   epoch 1 written once; (d) a world of 1 rank on NCCL takes the first
   step split over its group of one, against cuda:0 under (b)'s bounds.
   Times (CUDA events on rank 0, 10 turns after a warm-up): the split step
   on the 4 ranks (not a scaling figure: gloo stages the 101 MB all-reduce
   through the host) in turns with rank 0's single-device step on the whole
   batch.
22. The gradient gate at Cornell 512x512 x 32 spp x 5, NEE, on cuda:0, as
   two processes into a temporary directory: scripts/torch_grad_oracle.py
   (the f64 frozen-decision oracle and its per-pixel FD probes, each phase's
   seconds and peak memory) then scripts/torch_grad_gate.py (K2 fused
   against torch autograd; K1 colour + K4 and K3 fused against the oracle,
   per block; K1's colour against the recorded one; the FD rows). Each
   block's row, the record-point line and the FD rows are printed on lines
   of their own; a non-zero exit of either script or a FAIL fails the run.
   The kernels of these processes are not counted in the kernels line.
23. The port's bench, ``python -m pathtrace_tpu_torch.bench``, in a fresh
   process as a user runs it: at its defaults (512x512x32, 5 bounces, every
   card cell) and with ``--quick --full`` (128x128x4, the plain wavefront's
   legs on the card too), each within BENCH_TIMEOUT_S. Each must exit 0 and
   print JSON lines only, the first as soon as the headline is measured; the
   last line must hold every field of its cells, finite and positive, with
   backend "cuda", the card's name in ``device``, at least 10 samples a card
   field, ``0 < mfu <= 1``, and (defaults) ``pallas_fwd_ms`` within 0.5-2x
   phase 5's K1 time at 512x512x32. The last lines are printed. Their
   kernels are not counted in the kernels line.
24. The FMA question, ``python scripts/torch_fma_probe.py --json <tmp>
   --device 0`` in a fresh process within FMA_PROBE_TIMEOUT_S: the chains of
   ``scripts/fma_probe.py`` through ``torch.compile`` (Triton), then K6 and
   K7 through ``roofline.measure_f32_peak`` and ``roofline.latency_probe``
   (their plain versions are not run again: phase 11 holds them), then the
   discriminator. It must exit 0 and write a record with every key of
   docs/fma_probe_r5.json and of FMA_PROBE_KEYS, backend "cuda", the card's
   name in ``device``, every rate and latency finite and above 0, each
   compiled trip within its rtol of the eager trip, and K6 and K7 launched
   at least once each; the record is printed, with the SM clock nvidia-smi
   read right after the latency probe. The script counts K6's and K7's
   launches from 0; the kernels line adds them to phase 11's, and puts the
   cycles of a dependent ``fma`` step measured here beside K7's 4-cycle
   bound (``fma_dependent_cycles_measured``).
25. Launches that never wait for the card (the kernels take their scene,
   camera and seed blocks from device memory, as the TPU kernels take them
   from SMEM): (a) every entry point of the main paths
   (``main_path_calls``: the CLI's frame, ``render_aovs``,
   ``render_color_sums``, the three routes of ``fused_loss_grads`` and
   ``loss_and_grads``, ``nee_loss_and_grads``, ``ad_loss_and_grads``,
   ``cross_grads`` and the three inverse ``step_fn``s, at the bench's
   512x512x32 and the inverse steps' 256x256 sizes), with scene and camera
   on the host and on the card, runs under
   ``torch.cuda.set_sync_debug_mode("error")``, with the launch counts set to
   0 before and read after (the kernels line adds them); every output must
   be finite; (b) one launch of each kernel and mode (K1 in its three
   modes, K2 fused and dump, K5, K3 fused and replay, K4) is captured in a
   ``torch.cuda.CUDAGraph`` over static device blocks at 256x256x8; a
   changed scene (every albedo x0.9, sphere 6's radius x0.8) and the next
   frame's seed are copied into the blocks, and the replay must equal an
   eager launch on the new blocks to the bit and differ from the old
   blocks' output.

Before the kernels line, the seconds each phase took and the torch.profiler
sessions that saw no time of their kernel and were taken again.
The line before the last two is a JSON summary of the kernels, the next the
``nvidia-smi`` name and power limit, and the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

CASES = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"}}
MODES = ("channels", "partials", "color")
TIMING_ITERS = 10
PLAIN_32_ITERS = 2  # phase 5's plain version at 512x512x32, a turn
PLAIN_ITERS = 1  # in the plain/kernel/kernel turns
INVERSE_STEPS = 400


def run(cmd):
    """stdout of a command that must succeed."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip()


_T0 = time.perf_counter()


_PHASE_STARTS = {}
PROFILER_MISSES = []  # kernel_profiler_ms's sessions that saw no time of their kernel


def phase(n, title):
    _PHASE_STARTS[n] = time.perf_counter()
    print(f"== phase {n} (at {_PHASE_STARTS[n] - _T0:.0f} s): {title}", flush=True)


def phase_seconds() -> dict:
    """Seconds each phase took so far, by phase number ("kernels line": the
    bounds' segment counts and the summary after phase 23)."""
    marks = list(_PHASE_STARTS.items()) + [(None, time.perf_counter())]
    return {n: round(t1 - t0, 1) for (n, t0), (_, t1) in zip(marks, marks[1:])}


def compare(label, got, ref, mode, spp):
    """Hold ``got`` against ``ref`` on every channel and print one line per
    check; raise if any share is above its ceiling, or if the trace kernel
    (built without contraction) is not its plain version to the bit. -> max
    |got - ref|."""
    from pathtrace_tpu_torch.ops.trace_kernel import agreement

    checks, max_err = agreement(got, ref, mode, spp)
    for name, share, ceiling, ok in checks:
        print(f"  {label}: {name:14s} off on {share:.5f} of pixels (<= {ceiling}) "
              f"{'ok' if ok else 'FAIL'}")
    print(f"  {label}: max |diff| over all {got.shape[-1]} channels {max_err:.6g}")
    failed = [name for name, _, _, ok in checks if not ok]
    if failed:
        raise RuntimeError(f"kernel disagrees with the plain version: {label}: {failed}")
    if max_err != 0.0:
        raise RuntimeError(f"kernel is not its plain version to the bit: {label}")
    return max_err


# ---- the bit gate of K1, K2 and K5 (phase 17) --------------------------------------

DIGEST_CONFIGS = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"},
                  "nee_glossy": {"nee": True, "brdf": "glossy"}}


# sha256 of the outputs of the thread-a-pixel kernels of PR 1 and PR 2, as
# they stood before their redesign (scripts/torch_kernel_occupancy.py
# --digests on an H100), and the nvcc that built them.
DIGEST_NVCC = "Build cuda_12.9.r12.9/compiler.36037853_0"
KERNEL_DIGESTS = {
    "K1 diffuse channels 128x64x4": "754bc2d1f09b4c2638965462467af372614ce06cce1152aeaeb701c340c9e9d9",
    "K1 diffuse partials 128x64x4": "0f29f160865b8a4e23386e96675ecedfcd8404eb3ec12b887f6fec0e9afbcbc9",
    "K1 diffuse color 128x64x4": "1a1a2c967f6fac96698a814afe081b0001f5b0824f691e8210b47e3b06d38ed6",
    "K1 nee channels 128x64x4": "828e818c7025305daeaa3859d4acdc2b39a5556d34f74a73d7c5f68fc7ea9e10",
    "K1 nee partials 128x64x4": "34d28a27da2c5c67d3f03c426157b516dcacf5394183d632a1fa5967c49eb625",
    "K1 nee color 128x64x4": "7ce3efbe08feced8f0f9ab3aee65a05018e357f828c684bf1fa061ce9ab9400b",
    "K1 glossy channels 128x64x4": "698bc71ff31c681025e26064bdc73b36adabea2dfba6447edd6628a47ff04e16",
    "K1 glossy partials 128x64x4": "19c452fb39b3361ad0456c239237ab162ae4e4a4c82cbf9bd5b3aef5d34d1c4e",
    "K1 glossy color 128x64x4": "2564560090e7823713da7b240228d016313aa6171b7afb45a0a70d44f3f79e9a",
    "K1 nee_glossy channels 128x64x4": "d1f121885b56ea8dd24aaf3f79c5257f161f91d4554d5209580aab42156252e1",
    "K1 nee_glossy partials 128x64x4": "37276576c06f84b2d24ccb0999f3371a5a02af81d84a664eb6c5d1141a666384",
    "K1 nee_glossy color 128x64x4": "e7f382f2ec7fe3ca6580819f1df6cac47844299b9bbae23827478bd863ca0185",
    "K1 nee color 256x256x16": "a5a5b3c3ec23272d1933559c0cfac407e8911f4fc31236cd8abe19013514d4cd",
    "K1 glossy color 256x256x8": "9918a4db871fda663da6a4aed391d20b02daccb823adf911c8b35b00ae549a95",
    "K2 fused 256x256x8": "f26b224cd57283f2548179c68b4cf935dc5824b803e1f9f3197758b40bad21ab",
    "K2 dump 256x256x8": "d1020599ce4d62d0c40e0b074726bf13c880aeeb1ec21e14e67056f3d279e733",
    "K2 fused 512x512x32": "fe16d38aee7155a8e8548522887a81d871b2d1a0d1c8d0078ca3e9e147843dbf",
    "K2 dump 512x512x32": "27baa862e3ba55d8ab8c4dcc54ec031bb24fee335e6140489b67477a9ad130e6",
    "K5 replay 512x512x32": "6d994e4e8d2b864f1353b1adbd2e70d5897b7a5cf47c7bb856728a1a23d3ece5",
}


def kernel_digests(dev, tk, gk):
    """{case: sha256 of the bytes a kernel wrote} over the cases of the bit
    gate: K1 in its three modes under the four configurations at phase 3's
    case (128x64 of a 128x96 frame, 4 spp, row offset 16, sample offset 5)
    and its colour sums at the inverse steps' sizes (256x256x16 NEE, 256x256x8
    glossy); K2 fused (sums, colour) and dump (colour, accumulators) at
    256x256x8 and 512x512x32; K5 replay at 512x512x32. The target of the fused
    mode is a uniform draw from numpy's generator at seed 0, the replay's
    cotangent (target - 0.5) / 1000."""
    import hashlib

    import torch
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box

    sb, cam = cornell_box().packed(), Camera.create()

    def sha(*tensors):
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for case, extra in DIGEST_CONFIGS.items():
        cfg = RenderConfig(width=128, height=96, spp=4, **extra)
        cb, seed = tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 0, 5, 16)
        for mode in MODES:
            out[f"K1 {case} {mode} 128x64x4"] = sha(
                tk.trace(sb, cb, seed, cfg, local_h=64, spp=4, mode=mode, device=dev))
    for case, spp in (("nee", 16), ("glossy", 8)):
        cfg = RenderConfig(width=256, height=256, spp=spp, **DIGEST_CONFIGS[case])
        out[f"K1 {case} color 256x256x{spp}"] = sha(tk.trace(
            sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg), cfg, local_h=256, spp=spp,
            mode="color", device=dev))
    for size, spp in ((256, 8), (512, 32)):
        cfg = RenderConfig(width=size, height=size, spp=spp)
        cb, seed = tk.camera_block(cam, cfg), tk.make_seed_block(cfg)
        kw = dict(local_h=size, spp=spp, device=dev)
        target = torch.from_numpy(np.random.default_rng(0).uniform(
            size=(size, size, 3)).astype(np.float32)).to(dev)
        out[f"K2 fused {size}x{size}x{spp}"] = sha(*gk.fused(sb, cb, seed, cfg, target, **kw))
        out[f"K2 dump {size}x{size}x{spp}"] = sha(*gk.dump(sb, cb, seed, cfg, **kw))
        if size == 512:
            ct = ((target - 0.5) / 1000).contiguous()
            out[f"K5 replay {size}x{size}x{spp}"] = sha(gk.replay(sb, cb, seed, cfg, ct, **kw))
    return out


def kernel_profiler_ms(fn, iters, match):
    """(device ms a call of the kernels whose name holds ``match``, device ms
    a call of all device work) over ``iters`` calls under ``torch.profiler``:
    the kernel's own time, without the host's launch gap that a CUDA-event
    time of a single call includes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiling session has come back without the card's records of a
    # kernel it launched (phase 8's dump in one run on the H100, where phase
    # 5's session in the same process had its kernel's); the cause is not
    # known. One more session is taken, and a second miss fails the run.
    # Each miss is printed with what the session did record, and counted in
    # PROFILER_MISSES, which the summary line before the kernels line prints.
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        rows = [(e.key, e.self_device_time_total / 1e3 / iters) for e in events
                if e.device_type == DeviceType.CUDA]
        kernel = sum(ms for key, ms in rows if match in key)
        if kernel > 0:
            return kernel, sum(ms for _, ms in rows)
        launches = sum(e.count for e in events if "aunch" in e.key)
        PROFILER_MISSES.append(match)
        print(f"  torch.profiler session {attempt + 1} saw no device time of {match}: "
              f"{len(rows)} device rows ({[key[:60] for key, _ in rows[:8]]}), "
              f"{launches} launch calls on the host")
    raise RuntimeError(f"torch.profiler saw no device time of {match}")


def digest_phase_17(dev, tk, gk, nvcc):
    """The bit gate: every digest of ``kernel_digests`` equal to the one
    recorded from the kernels before their redesign."""
    phase(17, "the bit gate: digests of K1, K2 and K5 outputs against the recorded ones")
    got = kernel_digests(dev, tk, gk)
    differ = sorted(k for k in set(got) | set(KERNEL_DIGESTS) if got.get(k) != KERNEL_DIGESTS.get(k))
    for k, v in got.items():
        print(f"  {k:32s} {v[:16]} {'DIFFERS' if k in differ else 'ok'}")
    print(f"  recorded with {DIGEST_NVCC}; this build: {nvcc}")
    if differ:
        raise RuntimeError(f"outputs differ from the recorded digests ({DIGEST_NVCC}; this "
                           f"build {nvcc}): {differ}")


# (mode, name in the kernels line, the TPU kernel it replaces)
GRAD_KERNELS = (
    ("fused", "grad_kernel[fused]", "pathtrace_tpu/ops/pallas_grad.py:326"),
    ("dump", "grad_kernel[dump]", "pathtrace_tpu/ops/pallas_grad.py:326"),
    ("replay", "grad_kernel[replay]", "pathtrace_tpu/ops/pallas_grad.py:70"),
)


def grad_compare(label, got, ref, kind):
    """Hold ``got`` against ``ref`` under ``grad_kernel.agreement``, print one
    line per check and raise on a breach. -> max |got - ref|."""
    from pathtrace_tpu_torch.ops.grad_kernel import agreement

    checks, max_err = agreement(got, ref, kind)
    for name, share, ceiling, ok in checks:
        print(f"  {label}: {name:6s} off on {share:.5f} (<= {ceiling}) {'ok' if ok else 'FAIL'}")
    print(f"  {label}: max |diff| {max_err:.6g}")
    failed = [name for name, _, _, ok in checks if not ok]
    if failed:
        raise RuntimeError(f"disagreement: {label}: {failed}")
    return max_err


def flat_grads(d_e, d_c):
    """(d emission [N, 3], d albedo [N, 3]) -> [6N] in the kernel's layout."""
    import torch

    return torch.cat([d_e, d_c], dim=1).reshape(-1)


def grad_phase_6(dev, scene, cam, gk, tk):
    """The grad kernel's modes against their plain versions and each other."""
    import torch
    from pathtrace_tpu_torch import RenderConfig

    phase(6, "grad kernel vs plain on the card (128x64, 4 spp; the dump also at row "
             "offset 16, sample offset 5)")
    sb = scene.packed()
    cfg = RenderConfig(width=128, height=64, spp=4)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg, 3)
    kw = dict(local_h=64, spp=4, device=dev)
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(64, 128, 3)).astype(np.float32)).to(dev)
    err = {}

    before = gk.CUDA_KERNEL.launches["fused"]
    sums_f, color_f = gk.fused(sb, cb, seed, cfg, target, **kw)
    torch.cuda.synchronize()
    if gk.CUDA_KERNEL.launches["fused"] != before + 1:
        raise RuntimeError("the fused launch counter did not move")
    ref_sums, ref_color = gk.fused_plain(sb, cb, seed, cfg, target, **kw)
    err["fused"] = max(grad_compare("fused/sums", sums_f, ref_sums, "sums"),
                       grad_compare("fused/colour", color_f, ref_color, "color"))
    again, _ = gk.fused(sb, cb, seed, cfg, target, **kw)
    torch.cuda.synchronize()
    if not torch.equal(again, sums_f):
        raise RuntimeError("two fused launches gave different bits")
    print("  fused, launched twice: identical bits")

    cfg_d = RenderConfig(width=128, height=96, spp=4)
    cb_d = tk.camera_block(cam, cfg_d)
    seed_d = tk.make_seed_block(cfg_d, 0, 5, 16)
    color_d, acc_d = gk.dump(sb, cb_d, seed_d, cfg_d, **kw)
    torch.cuda.synchronize()
    ref_color_d, ref_acc_d = gk.dump_plain(sb, cb_d, seed_d, cfg_d, **kw)
    err["dump"] = max(grad_compare("dump/colour", color_d, ref_color_d, "color"),
                      grad_compare("dump/acc", acc_d, ref_acc_d, "acc"))

    # Replay against the MSE cotangent of the fused frame (1/spp folded in).
    ct = (2.0 * (color_f - target) / cfg.spp).contiguous()
    sums_r = gk.replay(sb, cb, seed, cfg, ct, **kw)
    torch.cuda.synchronize()
    ref_r = gk.replay_plain(sb, cb, seed, cfg, ct, **kw)
    err["replay"] = grad_compare("replay/sums", sums_r, ref_r, "sums")

    # The modes against each other on one frame: the same gradient sums.
    color_0, acc_0 = gk.dump(sb, cb, seed, cfg, **kw)
    contracted = flat_grads(*gk.contract(2.0 * (color_0 - target), acc_0))
    grad_compare("dump+contraction vs fused", contracted, sums_f[:-1], "sums")
    grad_compare("replay vs fused", sums_r[:-1], sums_f[:-1], "sums")
    return err


def grad_phase_7(dev, scene, cam, gk, tk):
    """The gradient paths at full size through the user entry points."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import RenderConfig, grad, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    def zero_counts():
        tk.CUDA_KERNEL.launches = 0
        for mode in gk.MODES:
            gk.CUDA_KERNEL.launches[mode] = 0

    phase(7, f"gradient paths at full size on cuda:0: (a) albedo recovery 256x256, 8 spp, "
             f"{INVERSE_STEPS} Adam steps; (b) fused loss+grads and (c) replay at 512x512x32")
    true_color = scene.color.numpy()
    bad = np.clip(true_color + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    corrupted = Scene(scene.radius, scene.position, scene.emission, bad)
    launches = {}

    cfg = RenderConfig(width=256, height=256, spp=8)
    zero_counts()
    t0 = time.perf_counter()
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # The first optimizer a process builds imports torch._dynamo (seconds).
    state, step_fn, _ = inverse.make_inverse_step(corrupted, cam, cfg, target, ("color",),
                                                  2e-2, device=dev)
    t2 = time.perf_counter()
    losses, step_ms = [], []
    for i in range(INVERSE_STEPS):
        before = gk.CUDA_KERNEL.launches["dump"]
        t_step = time.perf_counter()
        state, loss = step_fn(state)
        losses.append(float(loss))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        if gk.CUDA_KERNEL.launches["dump"] != before + 2:
            raise RuntimeError(f"inverse step {i} launched the dump kernel "
                               f"{gk.CUDA_KERNEL.launches['dump'] - before} times, not 2")
    recovered = inverse.apply_params(corrupted.to(dev), state.params).color.detach().cpu()
    wall = time.perf_counter() - t0
    launches["dump"] = gk.CUDA_KERNEL.launches["dump"]
    err_before = float(np.abs(bad - true_color).mean())
    err_after = float(np.abs(recovered.numpy() - true_color).mean())
    print(f"(a) launches: dump {launches['dump']}, trace {tk.CUDA_KERNEL.launches}, "
          f"fused {gk.CUDA_KERNEL.launches['fused']}, replay {gk.CUDA_KERNEL.launches['replay']}")
    print(f"(a) loss {losses[0]:.6f} (step 1) -> {losses[-1]:.6f} (step {INVERSE_STEPS}); "
          f"mean |albedo error| {err_before:.4f} -> {err_after:.4f}")
    print(f"(a) wall {wall:.2f} s: target render {1e3 * (t1 - t0):.1f} ms, make_inverse_step "
          f"{1e3 * (t2 - t1):.1f} ms, {INVERSE_STEPS} steps {sum(step_ms):.1f} ms; host-clock "
          f"step: first {step_ms[0]:.3f} ms, median {statistics.median(step_ms):.3f} ms, "
          f"max after the first {max(step_ms[1:]):.3f} ms")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("an inverse step gave a non-finite loss")
    if not err_after < 0.5 * err_before:
        raise RuntimeError(f"albedo error {err_after:.4f} is not below half of {err_before:.4f}")

    cfg = RenderConfig(width=512, height=512, spp=32)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    zero_counts()
    loss, (d_scene, d_cam) = grad.render_loss_grads(corrupted, cam, cfg, 0, target, device=dev)
    torch.cuda.synchronize()
    launches["fused"] = gk.CUDA_KERNEL.launches["fused"]
    print(f"(b) launches: fused {launches['fused']}, dump {gk.CUDA_KERNEL.launches['dump']}, "
          f"replay {gk.CUDA_KERNEL.launches['replay']}, trace {tk.CUDA_KERNEL.launches}")
    color = tk.render_color_sums(corrupted, cam, cfg, 0, device=dev) / cfg.spp
    mse = torch.mean((color - target) ** 2)
    print(f"(b) loss {float(loss):.8f}, MSE of the trace kernel's colour {float(mse):.8f}")
    grads = flat_grads(d_scene.emission, d_scene.color)
    zeros = [d_scene.position, d_scene.radius, d_cam.position, d_cam.yaw, d_cam.pitch]
    if not (torch.isfinite(grads).all() and float(grads.abs().max()) > 0):
        raise RuntimeError("fused gradients are not finite or all zero")
    if any(bool(z.any()) for z in zeros):
        raise RuntimeError("geometry or camera gradients are not exactly zero")
    if abs(float(loss) - float(mse)) > 1e-4 * abs(float(mse)):
        raise RuntimeError("the fused loss is not the MSE of the rendered colour")

    zero_counts()
    denom = cfg.height * cfg.width * 3
    d_e, d_c = gk.render_color_grads(corrupted, cam, cfg, 0, 2.0 * (color - target) / denom,
                                     device=dev)
    torch.cuda.synchronize()
    launches["replay"] = gk.CUDA_KERNEL.launches["replay"]
    print(f"(c) launches: replay {launches['replay']}, fused {gk.CUDA_KERNEL.launches['fused']}, "
          f"dump {gk.CUDA_KERNEL.launches['dump']}")
    grad_compare("(c) replay vs (b) fused", flat_grads(d_e, d_c), grads, "sums")
    for mode, n in launches.items():
        if n < 1:
            raise RuntimeError(f"the {mode} path did not launch its kernel")
    return launches


def plain_cross_grads(gk, tk, scene, cam, cfg, step, target, device):
    """``grad_kernel.cross_grads`` with the dump's plain version."""
    sb, cb = scene.to("cpu").packed(), tk.camera_block(cam.to("cpu"), cfg)
    kw = dict(local_h=cfg.height, spp=cfg.spp, device=device)
    a, acc_a = gk.dump_plain(sb, cb, tk.make_seed_block(cfg, 2 * step), cfg, **kw)
    b, acc_b = gk.dump_plain(sb, cb, tk.make_seed_block(cfg, 2 * step + 1), cfg, **kw)
    return gk.cross_contract(a, acc_a, b, acc_b, target)


def grad_phase_8(dev, scene, cam, gk, tk):
    """Kernel and plain times of the gradient kernels at the paths' shapes,
    and the last output of each held against the last of its plain version.
    -> ({(mode, "kernel" or "plain"): ms}, {mode: max |kernel - plain|})."""
    import torch
    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(8, f"grad timing (kernel: median of {2 * TIMING_ITERS} CUDA-event-timed runs; "
             f"plain: {PLAIN_ITERS} run after a warm-up; turns plain, kernel, kernel), and "
             f"each kernel's last output against its plain version's")
    sb = scene.packed()
    out, err = {}, {}

    def turns(label, kernel_fn, plain_fn):
        ms = {"kernel": [], "plain": []}
        last = {}
        for name in ("plain", "kernel", "kernel"):
            fn = kernel_fn if name == "kernel" else plain_fn
            iters = TIMING_ITERS if name == "kernel" else PLAIN_ITERS
            t, last[name] = time_fn(fn, warmup=2 if name == "kernel" else 1, iters=iters,
                                    device=dev)
            ms[name].extend(t)
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(f"{label}: kernel {med['kernel']:.4f} ms (runs {min(ms['kernel']):.4f}.."
              f"{max(ms['kernel']):.4f}), plain {med['plain']:.4f} ms (runs "
              f"{min(ms['plain']):.4f}..{max(ms['plain']):.4f}), plain/kernel "
              f"{med['plain'] / med['kernel']:.1f}")
        return med, last["kernel"], last["plain"]

    def held(mode, *errs):
        err[mode] = max(err.get(mode, 0.0), *errs)

    for spp in (32, 4):
        cfg = RenderConfig(width=512, height=512, spp=spp)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg)
        target = torch.full((512, 512, 3), 0.25, device=dev)
        kw = dict(local_h=512, spp=spp, device=dev)
        label = f"fused 512x512x{spp} spp x5"
        med, got, ref = turns(label, lambda: gk.fused(sb, cb, seed, cfg, target, **kw),
                              lambda: gk.fused_plain(sb, cb, seed, cfg, target, **kw))
        held("fused", grad_compare(f"{label}/sums", got[0], ref[0], "sums"),
             grad_compare(f"{label}/colour", got[1], ref[1], "color"))
        if spp == 32:
            out["fused", "kernel"], out["fused", "plain"] = med["kernel"], med["plain"]
            ct = torch.full((512, 512, 3), 1e-6, device=dev)
            label = "replay 512x512x32 spp x5"
            med, got, ref = turns(label, lambda: gk.replay(sb, cb, seed, cfg, ct, **kw),
                                  lambda: gk.replay_plain(sb, cb, seed, cfg, ct, **kw))
            held("replay", grad_compare(f"{label}/sums", got, ref, "sums"))
            out["replay", "kernel"], out["replay", "plain"] = med["kernel"], med["plain"]

    cfg = RenderConfig(width=256, height=256, spp=8)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg)
    kw = dict(local_h=256, spp=8, device=dev)
    label = "dump 256x256x8 spp x5"
    med, got, ref = turns(label, lambda: gk.dump(sb, cb, seed, cfg, **kw),
                          lambda: gk.dump_plain(sb, cb, seed, cfg, **kw))
    held("dump", grad_compare(f"{label}/colour", got[0], ref[0], "color"),
         grad_compare(f"{label}/acc", got[1], ref[1], "acc"))
    out["dump", "kernel"], out["dump", "plain"] = med["kernel"], med["plain"]
    prof, _ = kernel_profiler_ms(lambda: gk.dump(sb, cb, seed, cfg, **kw), 2 * TIMING_ITERS,
                                 "grad_kernel")
    print(f"{label}: events {med['kernel']:.4f} ms a call (the host's launch gap included), "
          f"torch.profiler {prof:.4f} ms of the kernel alone")
    target = torch.full((256, 256, 3), 0.25, device=dev)
    label = "cross-estimator loss+grads of one inverse step 256x256x8"
    _, got, ref = turns(label, lambda: gk.cross_grads(scene, cam, cfg, 0, target, device=dev),
                        lambda: plain_cross_grads(gk, tk, scene, cam, cfg, 0, target, dev))
    held("dump", grad_compare(f"{label}/loss+grads",
                              torch.cat([got[0][None], flat_grads(*got[1].values())]),
                              torch.cat([ref[0][None], flat_grads(*ref[1].values())]), "sums"))
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, device=dev)
    ms, _ = time_fn(step_fn, state, warmup=2, iters=2 * TIMING_ITERS, device=dev)
    print(f"inverse step 256x256x8 (kernel path, Adam included): "
          f"{statistics.median(ms):.4f} ms (runs {min(ms):.4f}..{max(ms):.4f})")
    return out, err


# ---- the NEE gradient path (phases 9, 10, 12) and the probes (phase 11) ------------

PUBLISHED_F32_FLOPS = 67e12  # NVIDIA H100 SXM data sheet, FMA counted as 2
# Cycles from an FFMA's issue to the issue of an FFMA that reads its result:
# 4 on Volta through Hopper by published microbenchmarks (Jia et al. 2018,
# "Dissecting the NVIDIA Volta GPU Architecture via Microbenchmarking"). The
# bound keeps this published figure; phase 24 measures the card's own
# (``fma_dependent_cycles_measured`` in the kernels line), which on an H100
# has read ~5.1, so K7's share of this bound is not headroom.
FMA_DEPENDENT_CYCLES = 4
PUBLISHED_BYTES_PER_S = 3.35e12
NEE_INVERSE_STEPS = 400


def nee_compare(label, got, ref, kind, cross=False):
    """Hold ``got`` against ``ref`` under ``nee_grad_kernel.agreement`` (its
    looser ``CROSS_ATOL`` where two orders of operations meet), print one
    line per check and raise on a breach. -> max |diff|."""
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk

    checks, max_err = nk.agreement(got, ref, kind, nk.CROSS_ATOL if cross else nk.SUMS_ATOL)
    line = ", ".join(f"{name} {share:.4f}" for name, share, _, _ in checks)
    print(f"  {label}: shares out of tolerance: {line}; max |diff| {max_err:.6g}")
    failed = [name for name, _, _, ok in checks if not ok]
    if failed:
        raise RuntimeError(f"disagreement: {label}: {failed}")
    return max_err


def nee_phase_9(dev, scene, cam, nk, tk):
    """The NEE grad kernel against its plain versions and its modes against
    each other. -> {mode: max |kernel - plain|}."""
    import torch
    from pathtrace_tpu_torch import RenderConfig

    phase(9, "NEE grad kernel vs plain on the card (128x64, 4 spp; also at row offset 16, "
             "sample offset 5; replay at 32 spp to the bit)")
    sb = scene.packed()
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(64, 128, 3)).astype(np.float32)).to(dev)
    err = {"fused": 0.0, "replay": 0.0}
    for height, seed_args in ((64, (3,)), (96, (0, 5, 16))):
        cfg = RenderConfig(width=128, height=height, spp=4, nee=True)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, *seed_args)
        kw = dict(local_h=64, spp=4, device=dev)
        tag = "" if height == 64 else " @offsets"
        before = nk.CUDA_KERNEL.launches["fused"]
        fused_sums, color = nk.fused(sb, cb, seed, cfg, target, **kw)
        torch.cuda.synchronize()
        if nk.CUDA_KERNEL.launches["fused"] != before + 1:
            raise RuntimeError("the NEE fused launch counter did not move")
        ref, ref_color = nk.fused_plain(sb, cb, seed, cfg, target, **kw)
        err["fused"] = max(err["fused"],
                           nee_compare(f"fused{tag}/sums", fused_sums, ref, "sums"),
                           nee_compare(f"fused{tag}/colour", color, ref_color, "color"))
        ct = (2.0 * (color - target) / cfg.spp).contiguous()
        replayed = nk.replay(sb, cb, seed, cfg, ct, **kw)
        torch.cuda.synchronize()
        err["replay"] = max(err["replay"], nee_compare(
            f"replay{tag}/sums", replayed, nk.replay_plain(sb, cb, seed, cfg, ct, **kw), "sums"))
        nee_compare(f"replay (MSE cotangent) vs fused{tag}",
                    torch.cat([replayed[:-1], fused_sums[-1:]]), fused_sums, "sums", cross=True)
        if height == 64:
            k1 = tk.trace(sb, cb, seed, cfg, mode="color", **kw)
            if not torch.equal(color, k1 * tk._f32(1.0 / cfg.spp)):
                raise RuntimeError("the fused colour is not the trace kernel's")
            print("  fused colour == trace kernel's NEE colour sums / spp: identical bits")
            again, _ = nk.fused(sb, cb, seed, cfg, target, **kw)
            if not torch.equal(again, fused_sums):
                raise RuntimeError("two NEE fused launches gave different bits")
            print("  fused, launched twice: identical bits")

    cfg = RenderConfig(width=128, height=64, spp=32, nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg, 3)
    kw = dict(local_h=64, spp=32, device=dev)
    ct = ((target - 0.5) / 32).contiguous()
    got = nk.replay(sb, cb, seed, cfg, ct, **kw)
    ref = nk.replay_plain(sb, cb, seed, cfg, ct, **kw)
    err["replay"] = max(err["replay"], nee_compare("replay 32 spp/sums", got, ref, "sums"))
    if not torch.equal(got, ref):
        raise RuntimeError("the 32-spp replay is not its plain version to the bit: do the "
                           "lane pairs add in the plain version's order, in double?")
    print("  replay 32 spp == plain version: identical bits (160 adds a geometry sum a lane, "
          "in double, in the plain version's order)")
    return err


def nee_phase_10(dev, scene, cam, gk, nk, tk):
    """The NEE gradient path at full size through the user entry points.
    -> ({mode: launches}, geometry errors)."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import RenderConfig, grad, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    def zero_counts():
        tk.CUDA_KERNEL.launches = 0
        for k in (gk, nk):
            for mode in k.MODES:
                k.CUDA_KERNEL.launches[mode] = 0

    phase(10, f"NEE gradient path at full size on cuda:0: (a) fused loss+grads 512x512x32; "
              f"(b) geometry recovery 256x256, 16 spp, {NEE_INVERSE_STEPS} Adam steps")
    pos_true, rad_true = scene.position.numpy(), scene.radius.numpy()
    bad_pos, bad_rad = pos_true.copy(), rad_true.copy()
    bad_pos[6] += np.array([6.0, -4.0, 8.0], np.float32)
    bad_rad[6] *= 0.8
    corrupted = Scene(bad_rad, bad_pos, scene.emission, scene.color)
    launches = {}

    cfg = RenderConfig(width=512, height=512, spp=32, nee=True)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    zero_counts()
    loss, (d_scene, d_cam) = grad.render_loss_grads(corrupted, cam, cfg, 0, target, device=dev)
    torch.cuda.synchronize()
    launches["fused"] = nk.CUDA_KERNEL.launches["fused"]
    print(f"(a) launches: NEE fused {launches['fused']}, NEE replay "
          f"{nk.CUDA_KERNEL.launches['replay']}, trace {tk.CUDA_KERNEL.launches}, "
          f"product-chain {sum(gk.CUDA_KERNEL.launches.values())}")
    if (launches["fused"], nk.CUDA_KERNEL.launches["replay"], tk.CUDA_KERNEL.launches,
            sum(gk.CUDA_KERNEL.launches.values())) != (1, 0, 0, 0):
        raise RuntimeError("render_loss_grads under NEE is not exactly one fused launch")
    color = tk.render_color_sums(corrupted, cam, cfg, 0, device=dev) / cfg.spp
    mse = torch.mean((color - target) ** 2)
    print(f"(a) loss {float(loss):.8f}, MSE of the trace kernel's colour {float(mse):.8f}")
    if abs(float(loss) - float(mse)) > 1e-4 * abs(float(mse)):
        raise RuntimeError("the NEE fused loss is not the MSE of the rendered colour")
    for name, g in (("d position", d_scene.position), ("d radius", d_scene.radius),
                    ("d emission", d_scene.emission), ("d albedo", d_scene.color),
                    ("d eye", d_cam.position), ("d yaw", d_cam.yaw), ("d pitch", d_cam.pitch)):
        print(f"(a) {name}: max |g| {float(g.abs().max()):.6g}")
        if g.device != dev or not torch.isfinite(g).all() or not float(g.abs().max()) > 0:
            raise RuntimeError(f"{name} is not finite and non-zero on {dev}")

    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    zero_counts()
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    torch.cuda.synchronize()
    tk.CUDA_KERNEL.launches = 0
    pos_mask = torch.zeros(9, 1)
    pos_mask[6] = 1.0
    rad_mask = torch.zeros(9)
    rad_mask[6] = 1.0
    rates = {"position": inverse.exponential_decay(0.5, NEE_INVERSE_STEPS, 0.02),
             "radius": inverse.exponential_decay(0.1, NEE_INVERSE_STEPS, 0.02)}
    state, step_fn, _ = inverse.make_inverse_step(
        corrupted, cam, cfg, target, ("position", "radius"), rates,
        grad_mask={"position": pos_mask, "radius": rad_mask}, device=dev)
    losses, step_ms = [], []
    for i in range(NEE_INVERSE_STEPS):
        before = (tk.CUDA_KERNEL.launches, nk.CUDA_KERNEL.launches["replay"])
        t_step = time.perf_counter()
        state, loss = step_fn(state)
        losses.append(float(loss))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        after = (tk.CUDA_KERNEL.launches, nk.CUDA_KERNEL.launches["replay"])
        if (after[0] - before[0], after[1] - before[1]) != (2, 2):
            raise RuntimeError(f"NEE inverse step {i} launched trace {after[0] - before[0]} and "
                               f"replay {after[1] - before[1]} times, not 2 and 2")
    launches["replay"] = nk.CUDA_KERNEL.launches["replay"]
    launches["trace"] = tk.CUDA_KERNEL.launches
    others = nk.CUDA_KERNEL.launches["fused"] + sum(gk.CUDA_KERNEL.launches.values())
    print(f"(b) launches: trace {launches['trace']}, NEE replay {launches['replay']}, "
          f"others {others}")
    if others:
        raise RuntimeError("the NEE inverse step launched another gradient kernel")
    rec = inverse.apply_params(corrupted.to(dev), state.params)
    pos_rec, rad_rec = rec.position.detach().cpu().numpy(), rec.radius.detach().cpu().numpy()
    off_start, off_end = bad_pos[6] - pos_true[6], pos_rec[6] - pos_true[6]
    errs = {"position": (float(np.linalg.norm(off_start)), float(np.linalg.norm(off_end))),
            "position across the view (x, y)": (float(np.linalg.norm(off_start[:2])),
                                                float(np.linalg.norm(off_end[:2]))),
            "radius": (float(abs(bad_rad[6] - rad_true[6])),
                       float(abs(rad_rec[6] - rad_true[6])))}
    frozen = np.arange(9) != 6
    if not (np.array_equal(pos_rec[frozen], pos_true[frozen])
            and np.array_equal(rad_rec[frozen], rad_true[frozen])):
        raise RuntimeError("a masked sphere moved")
    print(f"(b) loss {losses[0]:.6f} (step 1) -> {losses[-1]:.6f} (step {NEE_INVERSE_STEPS}); "
          f"sphere 6 position error {errs['position'][0]:.3f} -> {errs['position'][1]:.3f} "
          f"(offset {np.round(off_start, 2).tolist()} -> {np.round(off_end, 2).tolist()}), "
          f"radius error {errs['radius'][0]:.3f} -> {errs['radius'][1]:.3f}")
    print(f"(b) host-clock step: first {step_ms[0]:.3f} ms, median "
          f"{statistics.median(step_ms):.3f} ms, {NEE_INVERSE_STEPS} steps "
          f"{sum(step_ms):.1f} ms")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("an NEE inverse step gave a non-finite loss")
    met = all(errs[k][1] < 0.7 * errs[k][0] for k in ("position", "radius"))
    print(f"(b) the case's target (position and radius errors both below x0.7 of their start): "
          f"{'MET' if met else 'NOT MET'}: position "
          f"x{errs['position'][1] / errs['position'][0]:.3f}, radius "
          f"x{errs['radius'][1] / errs['radius'][0]:.3f}; offset along the view axis "
          f"{off_start[2]:.2f} -> {off_end[2]:.2f}")
    for name, (start, end) in errs.items():
        limit = 1.25 if name == "position" else 0.7
        print(f"(b) {name} error: {end:.3f} against {start:.3f}, x{end / start:.3f} "
              f"(the run stops at x{limit})")
        if not end < limit * start:
            raise RuntimeError(f"{name} error {end:.3f} is not below {limit} x {start:.3f}")
    return launches, errs


def probe_phase_11(dev, rf):
    """The probe kernel against its plain version, then the card's readings.
    -> (peaks, latencies, {probe: record})."""
    import torch
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(11, "f32 probes vs plain on the card, then the readings")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((1.0 + 0.1 * rng.uniform(size=(64, 128))).astype(np.float32)).to(dev)
    a = torch.from_numpy((0.9999 + 1e-4 * rng.uniform(size=(64, 128))).astype(np.float32)).to(dev)
    err = {"peak": 0.0, "latency": 0.0}

    def held(probe, label, got, ref):
        d = float((got - ref).abs().max())
        tol = 1e-6 * float(ref.abs().max())
        print(f"  {label}: max |diff| {d:.3g} (<= {tol:.3g}) {'ok' if d <= tol else 'FAIL'}")
        if not d <= tol:
            raise RuntimeError(f"probe kernel disagrees with its plain version: {label}")
        err[probe] = max(err[probe], d)

    for mode in rf.LATENCY_MODES:
        held("latency", f"latency[{mode}] 1 chain, 64 steps, varied inputs",
             rf.latency_chain(x, a, mode, 2), rf.chain_plain(x, a, mode, 2, 1))
    for fma in (True, False):
        held("peak", f"peak[{'fma' if fma else 'mul'}] 8 chains, 64 steps, varied inputs",
             rf.peak_chain(x, a, fma, 2),
             rf.chain_plain(x, a, "fma" if fma else "mul", 2, rf.PEAK_CHAINS))

    # At the shapes of the readings, on their inputs: the kernel (median of 3
    # timed launches) and the plain version of the same work (one timed run).
    def at_depth(probe, mode, xs, as_, iters, chains):
        if probe == "peak":
            kernel_fn = lambda: rf.peak_chain(xs, as_, mode == "fma", iters)  # noqa: E731
        else:
            kernel_fn = lambda: rf.latency_chain(xs, as_, mode, iters)  # noqa: E731
        ms, got = time_fn(kernel_fn, warmup=1, iters=3, device=dev)
        pms, ref = time_fn(lambda: rf.chain_plain(xs, as_, mode, iters, chains), warmup=0,
                           iters=1, device=dev)
        held(probe, f"{probe}[{mode}] {chains} chain(s), {xs.numel()} elements, "
                    f"{iters * rf.INNER} steps (kernel {statistics.median(ms):.4f} ms, plain "
                    f"{pms[0]:.1f} ms)", got, ref)
        return statistics.median(ms), pms[0]

    rec = {}
    xs, as_ = rf.probe_inputs(rf.PEAK_GRID * 64, dev)
    for mode in ("fma", "mul"):
        ms, pms = at_depth("peak", mode, xs, as_, rf.PEAK_ITERS, rf.PEAK_CHAINS)
        if mode == "fma":
            flops = 2.0 * xs.numel() * rf.PEAK_ITERS * rf.INNER * rf.PEAK_CHAINS
            rec["peak"] = dict(ms=ms, plain_ms=pms, ops_ms=1e3 * flops / PUBLISHED_F32_FLOPS,
                               bytes_ms=1e3 * 12.0 * xs.numel() / PUBLISHED_BYTES_PER_S)
    xs, as_ = rf.probe_inputs(rf.LATENCY_GRID * 8, dev)
    # The latency probe is one dependent chain a thread: its least time is the
    # chain's steps one after another at the FMA's dependent-issue latency and
    # the card's highest SM clock, not its operations over the f32 peak.
    sm_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"]).splitlines()[0])
    for mode in rf.LATENCY_MODES:
        full = mode == "fma"  # the timed row; a plain run at full depth takes a minute
        ms, pms = at_depth("latency", mode, xs, as_, rf.LATENCY_ITERS if full else 64, 1)
        if full:
            steps = rf.LATENCY_ITERS * rf.INNER
            flops = 2.0 * xs.numel() * steps
            rec["latency"] = dict(ms=ms, plain_ms=pms, ops_ms=1e3 * flops / PUBLISHED_F32_FLOPS,
                                  bytes_ms=1e3 * 12.0 * xs.numel() / PUBLISHED_BYTES_PER_S,
                                  latency_ms=1e3 * steps * FMA_DEPENDENT_CYCLES / (sm_mhz * 1e6),
                                  steps=steps, sm_mhz=sm_mhz)
            r = rec["latency"]
            print(f"  latency bound: {steps} dependent steps x {FMA_DEPENDENT_CYCLES} cycles "
                  f"(published; phase 24 measures the card's) / "
                  f"{sm_mhz:.0f} MHz (nvidia-smi clocks.max.sm) = {r['latency_ms']:.4f} ms; "
                  f"throughput bound {max(r['ops_ms'], r['bytes_ms']):.4f} ms")

    for k in rf.CUDA_KERNEL.launches:
        rf.CUDA_KERNEL.launches[k] = 0
    peaks = rf.measure_f32_peak(device=dev)
    lat = rf.latency_probe(device=dev)
    launches = dict(rf.CUDA_KERNEL.launches)
    print(f"f32 peak: FMA {peaks['peak_fma_flops'] / 1e12:.3f} TFLOP/s (2 a step), multiply "
          f"only {peaks['peak_mul_flops'] / 1e12:.3f} T operations/s; published "
          f"{PUBLISHED_F32_FLOPS / 1e12:.0f} TFLOP/s")
    print("dependent-chain latency, ns a step: "
          + ", ".join(f"{m} {lat[m]:.3f}" for m in rf.LATENCY_MODES))
    print(f"launches: {launches}")
    for probe, v in rec.items():
        v.update(launches=launches[probe], err=err[probe])
        if v["launches"] < 1:
            raise RuntimeError("a probe's entry point did not launch its kernel")
    return peaks, lat, rec


def single_plain_turns(dev, label, kernel_fn, plain_fn):
    """Times in turns plain, kernel, kernel: the kernel 2 x TIMING_ITERS
    CUDA-event-timed runs after warm-up, the plain version one run (1-8 s a
    call at the main paths' shapes, a time that is only printed and kept).
    -> (medians, the kernel's last output, the plain version's)."""
    from pathtrace_tpu_torch.utils.timing import time_fn

    ms = {"kernel": [], "plain": []}
    last = {}
    for name in ("plain", "kernel", "kernel"):
        if name == "kernel":
            t, last[name] = time_fn(kernel_fn, warmup=2, iters=TIMING_ITERS, device=dev)
        else:
            t, last[name] = time_fn(plain_fn, warmup=0, iters=1, device=dev)
        ms[name].extend(t)
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"{label}: kernel {med['kernel']:.4f} ms (runs {min(ms['kernel']):.4f}.."
          f"{max(ms['kernel']):.4f}), plain {med['plain']:.1f} ms, plain/kernel "
          f"{med['plain'] / med['kernel']:.1f}")
    return med, last["kernel"], last["plain"]


def profile_steps(label, step_fn, state, step_ms, steps=20):
    """``torch.profiler`` device times by kernel over ``steps`` inverse steps,
    and the device's idle share against ``step_ms``, the step's time without
    the profiler. A profiler that sees no device time fails the run, since
    PERF.md's breakdown of the step reads this. -> (device ms a step, idle
    share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step_fn(state)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "#" not in e.key]  # no annotations
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if not device_ms > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"torch.profiler over {steps} {label} steps: host wall {wall:.4f} ms a step "
          f"(under the profiler), device {device_ms:.4f} ms a step; against the step's "
          f"{step_ms:.4f} ms without the profiler the device is idle "
          f"{1.0 - device_ms / step_ms:.3f} of a step")
    for key, ms_ in rows[:6]:
        print(f"  {ms_:.4f} ms a step  {key[:90]}")
    return device_ms, 1.0 - device_ms / step_ms


def plain_nee_cross_grads(nk, tk, scene, cam, cfg, step, target, device):
    """``grad_kernel.cross_grads`` under NEE with the plain versions."""
    import torch

    sb, cb = scene.to("cpu").packed(), tk.camera_block(cam.to("cpu"), cfg)
    kw = dict(local_h=cfg.height, spp=cfg.spp, device=device)
    seeds = [tk.make_seed_block(cfg, 2 * step + k) for k in (0, 1)]
    a, b = (tk.trace_plain(sb, cb, sd, cfg, mode="color", **kw) / cfg.spp for sd in seeds)
    ra, rb = a - target, b - target
    denom = a.numel()
    sums = (nk.replay_plain(sb, cb, seeds[0], cfg, (rb / denom / cfg.spp).contiguous(), **kw)
            + nk.replay_plain(sb, cb, seeds[1], cfg, (ra / denom / cfg.spp).contiguous(), **kw))
    return torch.cat([sums[:-1], (torch.sum(ra * rb) / denom)[None]])


def nee_phase_12(dev, scene, cam, gk, nk, tk):
    """Kernel and plain times of the NEE grad kernel at the path's shapes,
    each last output held against its plain version's. -> (times, errors)."""
    import torch
    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(12, f"NEE grad timing (kernel: median of {2 * TIMING_ITERS} CUDA-event-timed runs; "
              f"plain: 1 run; turns plain, kernel, kernel)")
    sb = scene.packed()
    out, err = {}, {"fused": 0.0, "replay": 0.0}

    turns = functools.partial(single_plain_turns, dev)

    cfg = RenderConfig(width=512, height=512, spp=32, nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg)
    target = torch.full((512, 512, 3), 0.25, device=dev)
    ct = torch.full((512, 512, 3), 1e-6, device=dev)
    kw = dict(local_h=512, spp=32, device=dev)
    ms, _ = time_fn(lambda: tk.trace(sb, cb, seed, cfg, mode="color", **kw), warmup=2,
                    iters=2 * TIMING_ITERS, device=dev)
    out["color_nee", "kernel"] = statistics.median(ms)
    print(f"trace kernel, NEE colour sums 512x512x32 spp x5: {out['color_nee', 'kernel']:.4f} ms "
          f"(runs {min(ms):.4f}..{max(ms):.4f})")
    label = "NEE fused 512x512x32 spp x5"
    med, got, ref = turns(label, lambda: nk.fused(sb, cb, seed, cfg, target, **kw),
                          lambda: nk.fused_plain(sb, cb, seed, cfg, target, **kw))
    err["fused"] = max(err["fused"], nee_compare(f"{label}/sums", got[0], ref[0], "sums"),
                       nee_compare(f"{label}/colour", got[1], ref[1], "color"))
    out["fused", "kernel"], out["fused", "plain"] = med["kernel"], med["plain"]
    label = "NEE replay 512x512x32 spp x5"
    med, got, ref = turns(label, lambda: nk.replay(sb, cb, seed, cfg, ct, **kw),
                          lambda: nk.replay_plain(sb, cb, seed, cfg, ct, **kw))
    err["replay"] = max(err["replay"], nee_compare(f"{label}/sums", got, ref, "sums"))
    out["replay", "kernel"], out["replay", "plain"] = med["kernel"], med["plain"]
    print(f"the trace kernel's colour pass plus one replay launch: "
          f"{out['color_nee', 'kernel'] + out['replay', 'kernel']:.4f} ms")

    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    target = torch.full((256, 256, 3), 0.25, device=dev)

    def kernel_cross():
        loss, d = gk.cross_grads(scene, cam, cfg, 0, target, device=dev)
        return loss, d

    label = "NEE cross-estimator loss+grads of one inverse step 256x256x16"
    med, got, ref = turns(label, kernel_cross,
                          lambda: plain_nee_cross_grads(nk, tk, scene, cam, cfg, 0, target, dev))
    loss, d = got
    n = scene.num_objects
    flat = torch.cat([torch.cat([d["radius"][:, None], d["position"], d["emission"], d["color"]],
                                dim=1).reshape(-1), ref[10 * n: 10 * n + 15], loss[None]])
    err["replay"] = max(err["replay"], nee_compare(f"{label}/loss+grads", flat, ref, "sums"))
    out["cross", "kernel"], out["cross", "plain"] = med["kernel"], med["plain"]
    rates = {"position": inverse.exponential_decay(0.5, 400, 0.02),
             "radius": inverse.exponential_decay(0.1, 400, 0.02)}
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target,
                                                  ("position", "radius"), rates, device=dev)
    ms, _ = time_fn(step_fn, state, warmup=2, iters=2 * TIMING_ITERS, device=dev)
    out["step", "kernel"] = statistics.median(ms)
    print(f"NEE inverse step 256x256x16 (kernel path, Adam included): "
          f"{out['step', 'kernel']:.4f} ms (runs {min(ms):.4f}..{max(ms):.4f})")

    out["step", "device"], out["step", "idle"] = profile_steps("NEE inverse", step_fn, state,
                                                               out["step", "kernel"])
    return out, err


# ---- the all-parameter backward (K4) and the glossy paths (phases 13, 14, 15) --------

AD_CONFIGS = (("diffuse", False), ("diffuse", True), ("glossy", False), ("glossy", True))
GLOSSY_INVERSE_STEPS = 100


def ad_name(brdf, nee):
    return ("nee_" if nee else "") + brdf


def ad_phase_13(dev, scene, cam, ak, nk, tk):
    """K4 against its plain version on the card. -> max |kernel - plain|."""
    import torch
    from pathtrace_tpu_torch import RenderConfig

    phase(13, "all-parameter backward (K4) vs plain on the card (128x64, 4 spp; also at row "
              "offset 16, sample offset 2; one 32-spp launch)")
    sb = scene.packed()
    rng = np.random.default_rng(0)
    full = rng.normal(size=(ak.NUM_CT, 64, 128)).astype(np.float32)
    full[9] *= 1e-4  # depth is ~1e4 in these units
    full = torch.from_numpy(full).to(dev)
    colour = full.clone()
    colour[3:] = 0.0
    worst = 0.0
    for brdf, nee in AD_CONFIGS:
        name = ad_name(brdf, nee)
        cfg = RenderConfig(width=128, height=64, spp=4, brdf=brdf, nee=nee)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, 3)
        kw = dict(local_h=64, spp=4, device=dev)
        before = ak.CUDA_KERNEL.launches
        got = ak.replay(sb, cb, seed, cfg, colour, **kw)
        torch.cuda.synchronize()
        if ak.CUDA_KERNEL.launches != before + 1:
            raise RuntimeError("the K4 launch counter did not move")
        worst = max(worst, nee_compare(f"{name}/colour cotangent", got,
                                       ak.replay_plain(sb, cb, seed, cfg, colour, **kw), "sums"))
        if not torch.equal(ak.replay(sb, cb, seed, cfg, colour, **kw), got):
            raise RuntimeError(f"two K4 launches gave different bits ({name})")
        block = ak.block_from_sums(got)
        n = scene.num_objects
        geometry = max(float(block[:n, :4].abs().max()), float(block[n:, :3].abs().max()))
        print(f"  {name}: launched twice: identical bits; largest |geometry or camera sum| "
              f"{geometry:.6g}")
        if not nee and geometry != 0.0:
            raise RuntimeError(f"{name}: geometry and camera sums of a colour-only cotangent "
                               f"are not exactly 0")
        if nee and not geometry > 0.0:
            raise RuntimeError(f"{name}: no geometry gradient under NEE")
        if nee and brdf == "diffuse":
            k3 = nk.replay(sb, cb, seed, cfg, colour[:3].permute(1, 2, 0).contiguous(), **kw)
            if not torch.equal(got, k3):
                raise RuntimeError("K4 on NEE diffuse is not the NEE kernel's replay to the bit")
            print("  nee_diffuse: K4 == NEE kernel's replay: identical bits")
        got = ak.replay(sb, cb, seed, cfg, full, **kw)
        worst = max(worst, nee_compare(f"{name}/colour + normal + albedo + depth cotangents",
                                       got, ak.replay_plain(sb, cb, seed, cfg, full, **kw),
                                       "sums"))
        cfg_o = RenderConfig(width=128, height=96, spp=4, brdf=brdf, nee=nee)
        cb_o = tk.camera_block(cam, cfg_o)
        seed_o = tk.make_seed_block(cfg_o, 0, 2, 16)
        kw_o = dict(local_h=64, spp=2, device=dev)
        worst = max(worst, nee_compare(f"{name} @offsets",
                                       ak.replay(sb, cb_o, seed_o, cfg_o, full, **kw_o),
                                       ak.replay_plain(sb, cb_o, seed_o, cfg_o, full, **kw_o),
                                       "sums"))
    cfg = RenderConfig(width=128, height=64, spp=32, brdf="glossy", nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg, 3)
    kw = dict(local_h=64, spp=32, device=dev)
    got = ak.replay(sb, cb, seed, cfg, full, **kw)
    ref = ak.replay_plain(sb, cb, seed, cfg, full, **kw)
    worst = max(worst, nee_compare("nee_glossy 32 spp", got, ref, "sums"))
    print(f"  nee_glossy 32 spp == plain version to the bit: {bool(torch.equal(got, ref))}")
    return worst


def flat_scene_grads(d_scene):
    """Scene gradients -> [10N + 16] in the kernels' layout, zeros in the
    camera and loss slots (which ``agreement`` then passes)."""
    import torch

    rows = torch.cat([d_scene.radius[:, None], d_scene.position, d_scene.emission,
                      d_scene.color], dim=1).reshape(-1)
    return torch.cat([rows, rows.new_zeros(16)])


def camera_compare(label, d_cam, ref_cam, atol):
    """Camera gradients within rtol 1e-4 plus ``atol`` of the largest |ref|."""
    import torch

    got = torch.cat([d_cam.position, d_cam.yaw[None], d_cam.pitch[None]]).double().cpu()
    ref = torch.cat([ref_cam.position, ref_cam.yaw[None], ref_cam.pitch[None]]).double().cpu()
    diff = (got - ref).abs()
    ok = bool((diff <= 1e-4 * ref.abs() + atol * ref.abs().max()).all())
    print(f"  {label}: camera gradients max |diff| {float(diff.max()):.6g} (largest |ref| "
          f"{float(ref.abs().max()):.6g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"disagreement: {label}: camera gradients")
    return float(diff.max())


def ad_phase_14(dev, scene, cam, gk, nk, ak, tk):
    """The glossy gradient paths at full width through the user entry points.
    -> (K4 launches on these paths, max |kernel - plain| of the sums)."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import RenderConfig, grad, inverse, render_aovs
    from pathtrace_tpu_torch.scene import Scene

    def zero_counts():
        tk.CUDA_KERNEL.launches = 0
        ak.CUDA_KERNEL.launches = 0
        for k in (gk, nk):
            for mode in k.MODES:
                k.CUDA_KERNEL.launches[mode] = 0

    def counts():
        return (tk.CUDA_KERNEL.launches, ak.CUDA_KERNEL.launches,
                sum(nk.CUDA_KERNEL.launches.values()) + sum(gk.CUDA_KERNEL.launches.values()))

    phase(14, f"glossy gradient paths at full width on cuda:0: (a) render_loss_grads 512x512x32 "
              f"glossy and NEE glossy; (b) ad_loss_and_grads beside the NEE kernel on NEE "
              f"diffuse; (c) glossy albedo recovery 256x256, 8 spp, {GLOSSY_INVERSE_STEPS} steps")
    true_color = scene.color.numpy()
    bad = np.clip(true_color + np.random.default_rng(0).uniform(-0.35, 0.35, (9, 3)),
                  0.05, 0.95).astype(np.float32)
    corrupted = Scene(scene.radius, scene.position, scene.emission, bad)
    n = scene.num_objects
    launches, worst = 0, 0.0

    for nee in (False, True):
        name = ad_name("glossy", nee)
        cfg = RenderConfig(width=512, height=512, spp=32, brdf="glossy", nee=nee)
        target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                             device=dev)["color"]
        zero_counts()
        loss, (d_scene, d_cam) = grad.render_loss_grads(corrupted, cam, cfg, 0, target,
                                                        device=dev)
        torch.cuda.synchronize()
        seen = counts()
        launches += seen[1]
        print(f"(a) {name}: launches: trace {seen[0]}, K4 {seen[1]}, other gradient kernels "
              f"{seen[2]}")
        if seen != (1, 1, 0):
            raise RuntimeError(f"render_loss_grads for {name} is not one colour-sum launch and "
                               f"one K4 launch")
        # The plain route: trace_plain's colour, the loss's cotangent, replay_plain.
        sb, cb = corrupted.to("cpu").packed(), tk.camera_block(cam.to("cpu"), cfg)
        seed = tk.make_seed_block(cfg, 0)
        kw = dict(local_h=512, spp=32, device=dev)
        diff = tk.trace_plain(sb, cb, seed, cfg, mode="color", **kw) / cfg.spp - target
        denom = diff.numel()
        ct = ak.pack_cotangents(cfg, 2.0 * diff / denom, device=dev)
        ref_block = ak.block_from_sums(ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
        ref_scene, ref_cam = ak.grads_from_block(corrupted, cam, cfg, ref_block)
        ref_loss = torch.sum(diff * diff) / denom
        print(f"(a) {name}: loss {float(loss):.8f}, plain route {float(ref_loss):.8f}")
        if abs(float(loss) - float(ref_loss)) > 1e-4 * abs(float(ref_loss)):
            raise RuntimeError(f"{name}: the loss is not the plain route's")
        worst = max(worst, nee_compare(f"(a) {name}: scene gradients vs the plain route",
                                       flat_scene_grads(d_scene), flat_scene_grads(ref_scene),
                                       "sums"))
        camera_compare(f"(a) {name}", d_cam, ref_cam, 1e-6)
        for label, g in (("d albedo", d_scene.color), ("d emission", d_scene.emission),
                         ("d position", d_scene.position), ("d eye", d_cam.position)):
            print(f"(a) {name}: {label}: max |g| {float(g.abs().max()):.6g}")
            if g.device != dev or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: {label} is not finite on {dev}")
        if not float(d_scene.color.abs().max()) > 0:
            raise RuntimeError(f"{name}: the albedo gradient is all zero")
        if bool(d_scene.position.any()) != nee or bool(d_cam.position.any()) != nee:
            raise RuntimeError(f"{name}: geometry gradients must be non-zero under NEE and "
                               f"exactly zero without")

    cfg = RenderConfig(width=512, height=512, spp=32, nee=True)
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    zero_counts()
    loss, (d_scene, d_cam) = ak.ad_loss_and_grads(corrupted, cam, cfg, 0, target, device=dev)
    torch.cuda.synchronize()
    seen = counts()
    launches += seen[1]
    loss_3, (d_scene_3, d_cam_3) = nk.nee_loss_and_grads(corrupted, cam, cfg, 0, target,
                                                         device=dev)
    print(f"(b) nee_diffuse: launches: trace {seen[0]}, K4 {seen[1]}, others {seen[2]}; loss "
          f"{float(loss):.8f}, the NEE kernel's fused mode {float(loss_3):.8f}")
    if seen != (1, 1, 0):
        raise RuntimeError("ad_loss_and_grads is not one colour-sum launch and one K4 launch")
    if abs(float(loss) - float(loss_3)) > 1e-4 * abs(float(loss_3)):
        raise RuntimeError("ad_loss_and_grads' loss is not the NEE kernel's")
    nee_compare("(b) K4 route vs the NEE kernel's fused mode: scene gradients",
                flat_scene_grads(d_scene), flat_scene_grads(d_scene_3), "sums", cross=True)
    camera_compare("(b) K4 route vs the NEE kernel's fused mode", d_cam, d_cam_3, 1e-4)

    cfg = RenderConfig(width=256, height=256, spp=8, brdf="glossy")
    target = render_aovs(scene, cam, dataclasses.replace(cfg, spp=64), frame=987654,
                         device=dev)["color"]
    # The first three steps on the autograd route, from the same start.
    state_t, step_t, _ = inverse.make_inverse_step(
        corrupted, cam, dataclasses.replace(cfg, backend="torch"), target, ("color",), 2e-2,
        device=dev)
    want = []
    for _ in range(3):
        state_t, loss_t = step_t(state_t)
        want.append((float(loss_t), state_t.params["color"].grad.detach().clone()))
    zero_counts()
    state, step_fn, _ = inverse.make_inverse_step(corrupted, cam, cfg, target, ("color",), 2e-2,
                                                  device=dev)
    losses, step_ms = [], []
    for i in range(GLOSSY_INVERSE_STEPS):
        before = counts()
        t_step = time.perf_counter()
        state, loss = step_fn(state)
        losses.append(float(loss))  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        after = counts()
        if tuple(a - b for a, b in zip(after, before)) != (2, 2, 0):
            raise RuntimeError(f"glossy inverse step {i} launched trace, K4, others "
                               f"{tuple(a - b for a, b in zip(after, before))}, not 2, 2, 0")
        if i < 3:
            g, (loss_t, g_t) = state.params["color"].grad, want[i]
            d = float((g - g_t).abs().max())
            tol = 2e-2 * g_t.abs() + 2e-2 * g_t.abs().max()
            ok = (abs(losses[i] - loss_t) <= 1e-2 * abs(loss_t)
                  and bool(((g - g_t).abs() <= tol).all()))
            print(f"(c) step {i + 1}: loss {losses[i]:.8f}, autograd route {loss_t:.8f}; albedo "
                  f"gradient max |diff| {d:.3g} of largest {float(g_t.abs().max()):.3g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"glossy inverse step {i + 1} is not the autograd route's")
    launches += counts()[1]
    recovered = inverse.apply_params(corrupted.to(dev), state.params).color.detach().cpu().numpy()
    err_before, err_after = np.abs(bad - true_color), np.abs(recovered - true_color)
    print(f"(c) launches: trace {counts()[0]}, K4 {counts()[1]}, others {counts()[2]}")
    print(f"(c) loss {losses[0]:.6f} (step 1) -> {losses[-1]:.6f} (step {GLOSSY_INVERSE_STEPS}); "
          f"mean |albedo error| {err_before.mean():.4f} -> {err_after.mean():.4f}; by sphere "
          f"{[round(float(x), 3) for x in err_before.mean(axis=1)]} -> "
          f"{[round(float(x), 3) for x in err_after.mean(axis=1)]}")
    print(f"(c) host-clock step: first {step_ms[0]:.3f} ms, median "
          f"{statistics.median(step_ms):.3f} ms, {GLOSSY_INVERSE_STEPS} steps "
          f"{sum(step_ms):.1f} ms")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("a glossy inverse step gave a non-finite loss")
    if not err_after.mean() < err_before.mean():
        raise RuntimeError(f"mean albedo error {err_after.mean():.4f} is not below its start "
                           f"{err_before.mean():.4f}")
    return launches, worst


def ad_phase_15(dev, scene, cam, ak, nk, tk):
    """Kernel and plain times of K4 at the paths' shapes, each last output
    held against its plain version's. -> ({(name, "kernel" or "plain"): ms},
    max |kernel - plain|)."""
    import torch
    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(15, f"K4 timing (kernel: median of {2 * TIMING_ITERS} CUDA-event-timed runs; plain: "
              f"1 run; turns plain, kernel, kernel)")
    sb = scene.packed()
    out, worst = {}, 0.0

    def turns(label, kernel_fn, plain_fn):
        med, got, ref = single_plain_turns(dev, label, kernel_fn, plain_fn)
        return med, nee_compare(f"{label}/sums", got, ref, "sums")

    for size, spp, configs in ((512, 32, AD_CONFIGS[1:]), (256, 8, AD_CONFIGS[2:3])):
        ct = torch.zeros((ak.NUM_CT, size, size), device=dev)
        ct[:3] = 1e-6
        kw = dict(local_h=size, spp=spp, device=dev)
        for brdf, nee in configs:
            name = ad_name(brdf, nee)
            cfg = RenderConfig(width=size, height=size, spp=spp, brdf=brdf, nee=nee)
            cb = tk.camera_block(cam, cfg)
            seed = tk.make_seed_block(cfg)
            med, err = turns(f"K4 {name} {size}x{size}x{spp} spp x5",
                             lambda: ak.replay(sb, cb, seed, cfg, ct, **kw),
                             lambda: ak.replay_plain(sb, cb, seed, cfg, ct, **kw))
            worst = max(worst, err)
            out[name, size, "kernel"], out[name, size, "plain"] = med["kernel"], med["plain"]
            if size == 512 and name == "nee_diffuse":
                ct3 = ct[:3].permute(1, 2, 0).contiguous()
                ms, got = time_fn(lambda: nk.replay(sb, cb, seed, cfg, ct3, **kw), warmup=2,
                                  iters=2 * TIMING_ITERS, device=dev)
                print(f"the NEE kernel's replay beside it: {statistics.median(ms):.4f} ms (runs "
                      f"{min(ms):.4f}..{max(ms):.4f}); the same bits as K4: "
                      f"{bool(torch.equal(got, ak.replay(sb, cb, seed, cfg, ct, **kw)))}")
            if size == 512:
                ms, _ = time_fn(lambda: tk.trace(sb, cb, seed, cfg, mode="color", **kw),
                                warmup=2, iters=2 * TIMING_ITERS, device=dev)
                out[name, size, "color"] = statistics.median(ms)
                print(f"the trace kernel's colour sums for {name}: {out[name, size, 'color']:.4f} "
                      f"ms; colour pass plus one K4 launch (render_loss_grads): "
                      f"{out[name, size, 'color'] + med['kernel']:.4f} ms")

    cfg = RenderConfig(width=256, height=256, spp=8, brdf="glossy")
    target = torch.full((256, 256, 3), 0.25, device=dev)
    state, step_fn, _ = inverse.make_inverse_step(scene, cam, cfg, target, device=dev)
    ms, _ = time_fn(step_fn, state, warmup=2, iters=2 * TIMING_ITERS, device=dev)
    out["step"] = statistics.median(ms)
    print(f"glossy inverse step 256x256x8 (kernel path, Adam included): {out['step']:.4f} ms "
          f"(runs {min(ms):.4f}..{max(ms):.4f})")
    out["step", "device"], out["step", "idle"] = profile_steps("glossy inverse", step_fn, state,
                                                               out["step"])
    return out, worst


# ---- the shared reverse sweep (phase 16) -------------------------------------------

SM_SHARED_BYTES = 233472  # 228 KB an SM on sm_90
BLOCK_RESERVED_BYTES = 1024  # what the system keeps of it for each resident block
UNSHARED_RESIDENT_BLOCKS = 5  # 8x8 blocks an SM that one set of sums a thread would allow


def sweep_phase_16(dev, scene, cam, ak, nk, tk, nee_times, ad_times):
    """The sweep's instances on the card. -> ({name: ms}, max |kernel - plain|
    of the colour-only K4 instances, max of the NEE replay at 256x256x16).
    Without NEE the colour-only (shading-only) instances are held to their
    plain version here at 512x512x32 and 256x256x8. Under NEE they are held
    at that size to the bits of the full instance with zero AOV planes, which
    phase 15 holds to its plain version at 512x512x32; the colour-only NEE
    glossy instance itself meets its plain version at a step's size in
    phase 14, and all four at 128x64x4 here."""
    import torch
    from pathtrace_tpu_torch import RenderConfig
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(16, "the shared reverse sweep: resident blocks, the shading-only instances, the "
              "occupancy curve, the colour-only instances timed")
    sb, n = scene.packed(), scene.num_objects
    tape_bytes = 4 * 17 * nk.MAX_BOUNCES + 32  # the tape's local array and the forward's frame
    for block in (8, 16):
        rows = {f"K3 {mode}": nk.CUDA_KERNEL.occupancy(mode, block, n) for mode in nk.MODES}
        rows.update(ak.CUDA_KERNEL.instances(block, n))
        for name, occ in rows.items():
            print(f"  {block:2d}x{block:<2d} {name:42s} resident blocks an SM "
                  f"{occ['blocks_per_sm']:2d}  registers {occ['registers']:3d}  shared bytes "
                  f"{occ['shared_bytes']:6d}  local bytes {occ['local_bytes']}")
            geom = "shading only" not in name
            if occ["shared_bytes"] != nk.shared_bytes(n, block, geom):
                raise RuntimeError(f"{name}: the kernel's shared bytes are not the wrapper's")
            if occ["local_bytes"] > tape_bytes:
                raise RuntimeError(f"{name}: {occ['local_bytes']} local bytes a thread: spills?")
            if block == 8 and occ["blocks_per_sm"] <= UNSHARED_RESIDENT_BLOCKS:
                raise RuntimeError(f"{name}: no more than {UNSHARED_RESIDENT_BLOCKS} blocks an SM")

    rng = np.random.default_rng(0)
    full = rng.normal(size=(ak.NUM_CT, 64, 128)).astype(np.float32)
    full[3:] = 0.0
    full = torch.from_numpy(full).to(dev)
    only = full[:3].contiguous()
    worst = 0.0
    kw = dict(local_h=64, spp=4, device=dev)
    for brdf, nee in AD_CONFIGS:
        name = ad_name(brdf, nee)
        cfg = RenderConfig(width=128, height=64, spp=4, brdf=brdf, nee=nee)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, 3)
        got = ak.replay(sb, cb, seed, cfg, only, **kw)
        worst = max(worst, nee_compare(f"{name}/colour-only cotangent [3, h, W]", got,
                                       ak.replay_plain(sb, cb, seed, cfg, only, **kw), "sums"))
        if not torch.equal(ak.replay(sb, cb, seed, cfg, only, **kw), got):
            raise RuntimeError(f"two colour-only K4 launches gave different bits ({name})")
        if not torch.equal(got, ak.replay(sb, cb, seed, cfg, full, **kw)):
            raise RuntimeError(f"{name}: [3, h, W] is not [10, h, W] with zero planes to the bit")
        block = ak.block_from_sums(got)
        geometry = max(float(block[:n, :4].abs().max()), float(block[n:, :3].abs().max()))
        print(f"  {name}: {'shading-only' if not nee else 'colour-only'} instance == the full "
              f"one with zero AOV planes: identical bits; launched twice: identical bits; "
              f"largest |geometry or camera sum| {geometry:.6g}")
        if not nee and geometry != 0.0:
            raise RuntimeError(f"{name}: the shading-only instance's geometry sums are not 0")
        if nee and brdf == "diffuse":
            k3 = nk.replay(sb, cb, seed, cfg, only.permute(1, 2, 0).contiguous(), **kw)
            if not torch.equal(got, k3):
                raise RuntimeError("K4 colour-only on NEE diffuse is not the NEE kernel's replay")
            print("  nee_diffuse: K4 colour-only == NEE kernel's replay: identical bits")
    # an odd width, a ragged last block, and a last thread without a lane partner
    for brdf, nee in (("diffuse", True), ("glossy", False)):
        cfg = RenderConfig(width=123, height=61, spp=4, brdf=brdf, nee=nee, block=5)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, 3)
        ct = only[:, :61, :123].contiguous()
        kw_o = dict(local_h=61, spp=4, device=dev)
        worst = max(worst, nee_compare(f"{ad_name(brdf, nee)} 123x61, 5x5 blocks",
                                       ak.replay(sb, cb, seed, cfg, ct, **kw_o),
                                       ak.replay_plain(sb, cb, seed, cfg, ct, **kw_o), "sums"))

    print(f"occupancy curve: NEE replay, 8x8 blocks, dynamic shared memory padded; median of "
          f"{2 * TIMING_ITERS} launches")
    base = nk.CUDA_KERNEL.occupancy("replay", 8, n)
    for size, spp in ((512, 32), (256, 16)):
        cfg = RenderConfig(width=size, height=size, spp=spp, nee=True)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg)
        ct = torch.full((size, size, 3), 1e-6, device=dev)
        kw_c = dict(local_h=size, spp=spp, device=dev)
        first = None
        for want in range(1, base["blocks_per_sm"] + 1):
            total = (SM_SHARED_BYTES // want - BLOCK_RESERVED_BYTES) // 128 * 128
            pad = total - base["shared_bytes"] if want < base["blocks_per_sm"] else 0
            occ = nk.CUDA_KERNEL.occupancy("replay", 8, n, pad)
            ms, _ = time_fn(lambda: nk.CUDA_KERNEL.launch("replay", sb, cb, seed, cfg, ct,
                                                          pad_shared=pad, **kw_c),
                            warmup=2, iters=2 * TIMING_ITERS, device=dev)
            med = statistics.median(ms)
            first = med if first is None else first
            print(f"  {size}x{size}x{spp}: {occ['blocks_per_sm']} blocks an SM "
                  f"({2 * occ['blocks_per_sm']:2d} warps): {med:.4f} ms (runs {min(ms):.4f}.."
                  f"{max(ms):.4f}); x{first / med:.2f} of one block")
            if occ["blocks_per_sm"] != want:
                raise RuntimeError(f"padded for {want} blocks, the card keeps "
                                   f"{occ['blocks_per_sm']}")

    out, err_nee = {}, 0.0
    for size, spp, configs in ((512, 32, AD_CONFIGS), (256, 8, AD_CONFIGS[2:3])):
        ct = torch.full((ak.NUM_CT_COLOR, size, size), 1e-6, device=dev)
        kw_t = dict(local_h=size, spp=spp, device=dev)
        for brdf, nee in configs:
            name = ad_name(brdf, nee)
            cfg = RenderConfig(width=size, height=size, spp=spp, brdf=brdf, nee=nee)
            cb = tk.camera_block(cam, cfg)
            seed = tk.make_seed_block(cfg)
            label = f"K4 {name} colour-only {size}x{size}x{spp} spp x5"
            if nee:
                # Phase 15 holds this configuration's full instance against the
                # plain version at this size: here the colour-only instance is
                # timed and held to the full one's bits.
                ms, got = time_fn(lambda: ak.replay(sb, cb, seed, cfg, ct, **kw_t), warmup=2,
                                  iters=2 * TIMING_ITERS, device=dev)
                ten = torch.zeros((ak.NUM_CT, size, size), device=dev)
                ten[:3] = ct
                same = bool(torch.equal(got, ak.replay(sb, cb, seed, cfg, ten, **kw_t)))
                out[name, size, "kernel"] = statistics.median(ms)
                out[name, size, "plain"] = None  # timed for the full instance in phase 15
                print(f"{label}: kernel {out[name, size, 'kernel']:.4f} ms (runs {min(ms):.4f}.."
                      f"{max(ms):.4f}); the full instance's bits with zero AOV planes: {same}")
                if not same:
                    raise RuntimeError(f"{label}: not the full instance's bits")
                continue
            med, got, ref = single_plain_turns(
                dev, label, lambda: ak.replay(sb, cb, seed, cfg, ct, **kw_t),
                lambda: ak.replay_plain(sb, cb, seed, cfg, ct, **kw_t))
            worst = max(worst, nee_compare(f"{label}/sums", got, ref, "sums"))
            out[name, size, "kernel"], out[name, size, "plain"] = med["kernel"], med["plain"]
    cfg = RenderConfig(width=256, height=256, spp=16, nee=True)
    cb = tk.camera_block(cam, cfg)
    seed = tk.make_seed_block(cfg)
    ct = torch.full((256, 256, 3), 1e-6, device=dev)
    kw_t = dict(local_h=256, spp=16, device=dev)
    label = "NEE replay 256x256x16 spp x5"
    med, got, ref = single_plain_turns(dev, label,
                                       lambda: nk.replay(sb, cb, seed, cfg, ct, **kw_t),
                                       lambda: nk.replay_plain(sb, cb, seed, cfg, ct, **kw_t))
    err_nee = nee_compare(f"{label}/sums", got, ref, "sums")
    out["nee_replay", 256, "kernel"], out["nee_replay", 256, "plain"] = med["kernel"], med["plain"]
    print(f"the inverse steps (phases 12 and 15): NEE 256x256x16 {nee_times['step', 'kernel']:.4f} "
          f"ms a step, device {nee_times['step', 'device']:.4f} ms, idle "
          f"{nee_times['step', 'idle']:.3f}; glossy 256x256x8 {ad_times['step']:.4f} ms a step, "
          f"device {ad_times['step', 'device']:.4f} ms, idle {ad_times['step', 'idle']:.3f}")
    return out, worst, err_nee



# ---- the denoised frame, progressive accumulation and the interactive loop (phase 18) --

DENOISE_ATOL = 1e-4  # the card's f32 CNN against the CPU forward, absolute
PROGRESSIVE_BATCHES = (4, 8, 20)
STEPPER_SPP = [4, 8, 16, 32, 4, 8, 16, 32]  # 8 steps at 4 spp, a move between steps 4 and 5
PUBLISHED_TF32_FLOPS = 495e12  # NVIDIA H100 SXM data sheet, dense


def cnn_operations(model, x):
    """Operations of one forward of ``model`` on ``x``, counted over its
    convolutions: 2 x (input channels x kernel area) for the multiply-adds of
    an output element, plus its bias add. BatchNorm, ReLU, the resizes and
    the adds are left out (one or two operations an element of an
    activation, under 1% of the total)."""
    import torch
    from torch import nn

    counts = []

    def hook(module, _, out):
        k = module.kernel_size[0] * module.kernel_size[1]
        counts.append(out.numel() * (2 * module.in_channels // module.groups * k + 1))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return sum(counts)


def denoise_phase_18(dev, tk, smi):
    """The reference's second mode end to end (SURVEY.md §3.2): render, CNN,
    display, interactive control, on the card through K1 and cuDNN. Raises
    on any failure. -> {name: ms}."""
    import dataclasses

    import torch
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.interactive import FrameStepper
    from pathtrace_tpu_torch.io.bmp import read_bmp
    from pathtrace_tpu_torch.io.exr import load_aovs_exr
    from pathtrace_tpu_torch.models import init_model, preprocess_channels
    from pathtrace_tpu_torch.models.denoise_cnn import cudnn_tf32
    from pathtrace_tpu_torch.models.infer import denoise_channels, load_pretrained
    from pathtrace_tpu_torch.progressive import ProgressiveRenderer, merge_partials
    from pathtrace_tpu_torch.render import (finalize_aovs, render_aovs, render_channels,
                                            unpack_channels)
    from pathtrace_tpu_torch.train import save_checkpoint
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(18, "the denoised frame (CLI -d), progressive accumulation, FrameStepper and the "
              "interactive loop at 512x512 on cuda:0; weights from init_model(seed 0)")
    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=512, height=512, spp=4)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_denoise_")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, init_model(torch.Generator().manual_seed(0)))

        # (a) The CLI's denoised frame, held to the CPU forward on the same buffer.
        prefix = os.path.join(tmp, "frame")
        tk.CUDA_KERNEL.launches = 0
        rc = cli.main(["-d", "--checkpoint", ckpt, "--size", "512", "-s", "4", "--device", "0",
                       "--nobitmap", "-o", prefix])
        launches = tk.CUDA_KERNEL.launches
        if rc != 0 or launches < 1:
            raise RuntimeError(f"CLI -d exited {rc} after {launches} trace kernel launches")
        got = load_aovs_exr(prefix + ".exr")
        buf = render_channels(scene, cam, cfg, 1, dev)  # the CLI's frame 1, K1's bits again
        raw = {k: v.cpu().numpy() for k, v in unpack_channels(buf).items()}
        same = [k for k in raw if k != "color" and np.array_equal(got[k], raw[k])]
        if len(same) != len(raw) - 1:
            raise RuntimeError(f"the EXR's AOVs are not the re-rendered frame's: only {same}")
        want = denoise_channels(buf.cpu(), ckpt).numpy()
        err = float(np.abs(got["color"] - want).max())
        inside = float(((want > 0.0) & (want < 1.0)).mean())
        print(f"(a) CLI -d 512x512x4: {launches} trace kernel launches; denoised colour "
              f"(EXR) vs the CPU forward on the same buffer: max |diff| {err:.3g} "
              f"(<= {DENOISE_ATOL}); {inside:.3f} of the values inside (0, 1)")
        if not err <= DENOISE_ATOL or not np.isfinite(got["color"]).all():
            raise RuntimeError("the denoised frame disagrees with the CPU forward")

        # (b) Progressive batches on the default device: kernel route = the
        # plain partials of the same batches to the bit; = one 32-spp render
        # to the 1e-3 rule.
        tk.CUDA_KERNEL.launches = 0
        prog = ProgressiveRenderer(scene, cam, cfg)
        for spp in PROGRESSIVE_BATCHES:
            prog.accumulate(spp)
        got = prog.aovs()
        launches = tk.CUDA_KERNEL.launches
        if launches != len(PROGRESSIVE_BATCHES) or prog.device.type != "cuda":
            raise RuntimeError(f"progressive: {launches} launches on {prog.device}")
        sb, cb = scene.packed(), tk.camera_block(cam, cfg)
        merged, offset = None, 0
        for spp in PROGRESSIVE_BATCHES:
            part = tk.partials_from_block(tk.trace_plain(
                sb, cb, tk.make_seed_block(cfg, 0, offset), cfg, local_h=512, spp=spp,
                mode="partials", device=dev))
            merged = part if merged is None else merge_partials(*merged, *part)
            offset += spp
        plain = finalize_aovs(*merged, offset)
        differ = [k for k in got if not torch.equal(got[k], plain[k])]
        mono = render_aovs(scene, cam, dataclasses.replace(cfg, spp=offset), 0, dev)
        worst = {k: float(((got[k] - mono[k]).abs() - 1e-3 * mono[k].abs()).max())
                 for k in got}
        print(f"(b) ProgressiveRenderer 512x512, batches {PROGRESSIVE_BATCHES}: {launches} "
              f"trace kernel launches; kernel route vs plain route on the same batches: "
              f"{'bit-equal' if not differ else f'DIFFER in {differ}'}; vs one {offset}-spp "
              f"render, largest excess over rtol/atol 1e-3: {max(worst.values()):.3g}")
        if differ:
            raise RuntimeError(f"progressive kernel route is not its plain route: {differ}")
        if not max(worst.values()) <= 1e-3:
            raise RuntimeError(f"progressive batches differ from one render: {worst}")

        # (c) The viewer's stepper: progressive, denoised, one move.
        tk.CUDA_KERNEL.launches = 0
        stepper = FrameStepper(scene, cam, cfg, denoising=True, checkpoint=ckpt,
                               progressive=True)
        seen = []
        for i in range(len(STEPPER_SPP)):
            if i == 4:
                stepper.move("forward", 0.1)
            rgb = stepper.step()
            if rgb.dtype != np.uint8 or rgb.shape != (512, 512, 3):
                raise RuntimeError(f"stepper frame {i}: {rgb.dtype} {rgb.shape}")
            if not all(torch.isfinite(v).all() for v in stepper._prog.aovs().values()):
                raise RuntimeError(f"stepper frame {i}: non-finite AOVs")
            seen.append(stepper.spp_accumulated)
        launches = tk.CUDA_KERNEL.launches
        print(f"(c) FrameStepper(progressive, denoising) 512x512x4, a move after step 4: spp "
              f"{seen}, {launches} trace kernel launches, frames uint8 [512, 512, 3]")
        if seen != STEPPER_SPP or launches != len(STEPPER_SPP):
            raise RuntimeError(f"stepper spp {seen} (want {STEPPER_SPP}), {launches} launches")

        # (d) The interactive loop through the CLI.
        tk.CUDA_KERNEL.launches = 0
        out = os.path.join(tmp, "run", "out")
        rc = cli.main(["-i", "--frames", "3", "-d", "--checkpoint", ckpt, "--size", "512",
                       "--device", "0", "-o", out, "--metrics", os.path.join(tmp, "m.jsonl")])
        frames = sorted(os.listdir(os.path.join(tmp, "run", "frames")))
        launches = tk.CUDA_KERNEL.launches
        print(f"(d) CLI -i --frames 3 -d: exit {rc}, {frames}, {launches} trace kernel launches")
        if rc != 0 or len(frames) != 3 or launches != 3:
            raise RuntimeError("the interactive loop did not write 3 frames")
        if read_bmp(os.path.join(tmp, "run", "frames", frames[-1])).shape != (512, 512, 3):
            raise RuntimeError("a frame of the interactive loop has the wrong shape")

        # (e) Times by CUDA events, median of 20 after warm-up.
        model = load_pretrained(ckpt, dev)
        x = preprocess_channels(buf)[None]
        n_ops = cnn_operations(model, x)
        times = {}

        def cnn(tf32):
            with torch.inference_mode(), cudnn_tf32(tf32):
                return model(x)

        for name, fn in (("cnn_f32", lambda: cnn(False)), ("cnn_tf32", lambda: cnn(True)),
                         ("cnn_f32 ", lambda: cnn(False)), ("cnn_tf32 ", lambda: cnn(True))):
            ms, _ = time_fn(fn, warmup=3, iters=TIMING_ITERS, device=dev)
            times.setdefault(name.strip(), []).extend(ms)
        render = lambda: render_channels(scene, cam, cfg, 1, dev)  # noqa: E731
        frame = lambda: denoise_channels(render_channels(scene, cam, cfg, 1, dev), ckpt)  # noqa
        times["render"], _ = time_fn(render, warmup=3, iters=2 * TIMING_ITERS, device=dev)
        times["denoised_frame"], _ = time_fn(frame, warmup=3, iters=2 * TIMING_ITERS,
                                             device=dev)
        k1_ms, device_ms = kernel_profiler_ms(frame, 2 * TIMING_ITERS, "pathtrace_kernel")

        def step_after_move():
            stepper.move("right", 1.0 / 120.0)
            return stepper.step()

        times["step"], _ = time_fn(step_after_move, warmup=3, iters=2 * TIMING_ITERS,
                                   device=dev)
        med = {k: statistics.median(v) for k, v in times.items()}
        # The CNN's device time alone (every kernel it launches), beside the
        # events' time, which holds the host's launches.
        device = {tf32: kernel_profiler_ms(lambda: cnn(tf32), 2 * TIMING_ITERS, "")[1]
                  for tf32 in (False, True)}
        print(f"(e) card: {smi}; CUDA events, median of {2 * TIMING_ITERS} after warm-up "
              f"(runs min..max):")
        for key, tf32, label, peak in (
                ("cnn_f32", False, "CNN alone 512x512, f32 (TF32 off)", PUBLISHED_F32_FLOPS),
                ("cnn_tf32", True, "CNN alone 512x512, TF32", PUBLISHED_TF32_FLOPS)):
            rate = n_ops / (med[key] / 1e3)
            print(f"  {label}: {med[key]:.4f} ms ({min(times[key]):.4f}..{max(times[key]):.4f});"
                  f" {n_ops} operations (convolutions, a multiply-add as two) = "
                  f"{rate / 1e12:.2f} TFLOP/s, {rate / peak:.3f} of the published "
                  f"{peak / 1e12:.0f} TFLOP/s; torch.profiler device time {device[tf32]:.4f} ms "
                  f"({n_ops / (device[tf32] / 1e3) / peak:.3f} of the peak), device idle "
                  f"{1.0 - device[tf32] / med[key]:.3f}")
        print(f"  render alone 512x512x4 (K1 + host): {med['render']:.4f} ms "
              f"({min(times['render']):.4f}..{max(times['render']):.4f})")
        print(f"  denoised frame 512x512x4 (render + preprocess + CNN f32): "
              f"{med['denoised_frame']:.4f} ms ({min(times['denoised_frame']):.4f}.."
              f"{max(times['denoised_frame']):.4f}); torch.profiler device time a frame "
              f"{device_ms:.4f} ms, of it K1 {k1_ms:.4f} ms; device idle "
              f"{1.0 - device_ms / med['denoised_frame']:.3f} of the frame")
        print(f"  progressive FrameStepper.step after a move (render 4 spp + CNN + fade + copy "
              f"to the host): {med['step']:.4f} ms ({min(times['step']):.4f}.."
              f"{max(times['step']):.4f}); the stepper's own clock {stepper.last_ms:.4f} ms")
        return med
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the denoiser's training path (phase 19) ---------------------------------------

# The JAX training CLI's defaults (pathtrace_tpu/train.py:493-540): 33 poses
# at 256x256, 16 patches of 64x64 an image, 2 / 512 spp, batch 5.
TRAIN_SIZE, TRAIN_POSES, TRAIN_PATCH, TRAIN_PER_IMAGE = 256, 33, 64, 16
TRAIN_SPP, TRAIN_SPP_GT, TRAIN_BATCH = 2, 512, 5
GT_ROWS, GT_ROW_OFFSET = 32, 112  # the crop of the 512-spp launch held to its plain version
# The card's training steps against the same port code on the CPU (losses
# within rtol LOSS_RTOL): every tensor (weights, BN statistics, momentum)
# within TRAIN_REL of its largest |value| plus TRAIN_ATOL, and the update as
# a whole, the norm of the difference of the two updates over the norm of
# one, within TRAIN_UPDATE_L2. Measured on an NVIDIA H100 (700 W): 0.0072
# (a conv bias ahead of a BatchNorm, whose gradient mostly cancels), 2.2e-5
# of the update, losses 4e-6.
TRAIN_REL, TRAIN_ATOL, TRAIN_UPDATE_L2 = 2e-2, 1e-6, 1e-3
LOSS_RTOL = 1e-5
# Adam moves each weight by about lr whatever its gradient's size, so a
# weight whose gradient is mostly rounding moves another way on each device:
# the simple CNN's 3-step update is held as a whole only (measured 0.042).
ADAM_LR, ADAM_UPDATE_L2 = 1e-4, 0.2
# A whole epoch of each route through the CLI, against a gross fault, beside
# the bits: until the training step was made deterministic, the updates of
# two runs of one route spread apart by up to 0.092 of their norm.
SCAN_EPOCH_L2 = 0.5
# An epoch is 105 steps (1.4-3.6 s on an H100, by host): one timed epoch of
# each route after its warm-up keeps the whole script near its budget on a
# slow host.
STEP_ITERS, EPOCH_ITERS = 20, 1


def state_errors(got, want):
    """(largest |got - want| over the largest |want| of its tensor, its name)
    over every tensor of ``want`` (name -> tensor); BN's batch counters are
    left out."""
    worst = (0.0, "")
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        err = float((got[name].float() - ref.float()).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, (err / scale if scale > 0 else err, name))
    return worst


def update_l2(got, want, start):
    """||(got - start) - (want - start)|| / ||want - start|| over every float
    tensor of ``want``: how far one device's update is from the other's."""
    num = den = 0.0
    for name, ref in want.items():
        if not ref.is_floating_point():
            continue
        num += float((got[name].cpu().double() - ref.double()).pow(2).sum())
        den += float((ref.double() - start[name].cpu().double()).pow(2).sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def hold_states(label, got, want):
    """Hold a card-side state dict to a CPU-side one under TRAIN_REL and
    TRAIN_ATOL; print the worst tensor. -> its share of its largest value."""
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        bound = TRAIN_REL * float(ref.abs().max()) + TRAIN_ATOL
        if not float((got[name].float() - ref.float()).abs().max()) <= bound:
            raise RuntimeError(f"{label}: {name} off by more than {bound:.3g}")
    rel, name = state_errors(got, want)
    print(f"  {label}: worst {rel:.3g} of its tensor's largest |value| ({name})")
    return rel


def train_phase_19(dev, tk, smi):
    """The denoiser's training path at the JAX CLI's full defaults on the
    card: the dataset through K1, the card's steps against the CPU's, the
    training CLI with its checkpoints and resume, and the times. Raises on
    any failure. -> {name: ms}."""
    import copy
    import dataclasses
    import glob

    import torch
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import cli, train
    from pathtrace_tpu_torch.data.collect import random_pose, render_pair
    from pathtrace_tpu_torch.io import native
    from pathtrace_tpu_torch.io.bmp import encode_bmp, read_bmp, write_bmp
    from pathtrace_tpu_torch.io.exr import load_aovs_exr, read_exr, write_exr
    from pathtrace_tpu_torch.models import init_model
    from pathtrace_tpu_torch.models.simple_cnn import create_simple_state, simple_train_step
    from pathtrace_tpu_torch.utils.timing import time_fn

    phase(19, f"the training path at the JAX CLI's defaults on cuda:0: {TRAIN_POSES} poses at "
              f"{TRAIN_SIZE}x{TRAIN_SIZE}, {TRAIN_SPP}/{TRAIN_SPP_GT} spp, {TRAIN_PER_IMAGE} "
              f"patches of {TRAIN_PATCH}x{TRAIN_PATCH} an image, the full-width CNN, batch "
              f"{TRAIN_BATCH}")
    scene = cornell_box()
    cfg = RenderConfig(width=TRAIN_SIZE, height=TRAIN_SIZE, spp=2, backend="auto")

    # (a) One ground-truth launch (512 spp, the derived config of
    # render_pair) against the plain version on a crop of rows, phase 3's
    # rules, then the dataset and the validation pair.
    pose = random_pose(np.random.default_rng(0))
    cam = Camera.create(position=pose[:3], yaw=pose[3], pitch=pose[4])
    gt_cfg = dataclasses.replace(cfg, spp=TRAIN_SPP_GT, spp_chunk=64, seed=cfg.seed + 1)
    sb, cb = scene.packed(), tk.camera_block(cam, gt_cfg)
    seed = tk.make_seed_block(gt_cfg, 0, 0, GT_ROW_OFFSET)
    gt_err = 0.0
    for mode in ("partials", "channels"):
        kw = dict(local_h=GT_ROWS, spp=TRAIN_SPP_GT, mode=mode, device=dev)
        got = tk.trace(sb, cb, seed, gt_cfg, **kw)
        ref = tk.trace_plain(sb, cb, seed, gt_cfg, **kw)
        print(f"(a) a {TRAIN_SPP_GT}-spp ground-truth launch, rows {GT_ROW_OFFSET}.."
              f"{GT_ROW_OFFSET + GT_ROWS} of pose 0 ({tk.MODES[mode]} channels) vs plain:")
        gt_err = max(gt_err, compare(f"gt{TRAIN_SPP_GT}/{mode}", got, ref, mode, TRAIN_SPP_GT))

    tk.CUDA_KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inputs, targets = train.build_dataset(
        scene, cfg, n_poses=TRAIN_POSES, patch_size=TRAIN_PATCH,
        patches_per_image=TRAIN_PER_IMAGE, spp_train=TRAIN_SPP, spp_gt=TRAIN_SPP_GT, seed=0,
        device=dev)
    vnoisy, vgt = render_pair(scene, train.DEFAULT_POSE, cfg, TRAIN_SPP, TRAIN_SPP_GT,
                              frame=train.VALIDATION_FRAME, device=dev)
    dataset_s = time.perf_counter() - t0
    launches = tk.CUDA_KERNEL.launches
    n = TRAIN_POSES * TRAIN_PER_IMAGE
    print(f"(a) build_dataset + the validation pair: {dataset_s:.2f} s, {launches} trace kernel "
          f"launches (want {2 * TRAIN_POSES + 2}); inputs {inputs.shape} "
          f"({inputs.nbytes / 1e6:.1f} MB), targets {targets.shape} "
          f"({targets.nbytes / 1e6:.1f} MB)")
    if launches != 2 * TRAIN_POSES + 2:
        raise RuntimeError(f"the dataset took {launches} trace kernel launches")
    if inputs.shape != (n, TRAIN_PATCH, TRAIN_PATCH, 14) or targets.shape != (
            n, TRAIN_PATCH, TRAIN_PATCH, 3):
        raise RuntimeError(f"dataset shapes {inputs.shape}, {targets.shape}")
    if not (np.isfinite(inputs).all() and np.isfinite(targets).all()
            and targets.min() >= 0.0 and targets.max() <= 1.0 and np.isfinite(vgt).all()):
        raise RuntimeError("the dataset holds non-finite values or targets outside [0, 1]")

    # (b) Three steps on the card against the same code on the CPU, from the
    # same weights and batches: the card's only correctness gate of the
    # trainer (the machine has no JAX; the CPU is held to JAX by the tests).
    model0 = init_model(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model0.parameters())
    states = {d: train.create_state(copy.deepcopy(model0), d) for d in (dev, "cpu")}
    losses = {d: [] for d in states}
    for i in range(3):
        batch = torch.from_numpy(inputs[TRAIN_BATCH * i: TRAIN_BATCH * (i + 1)])
        target = torch.from_numpy(targets[TRAIN_BATCH * i: TRAIN_BATCH * (i + 1)])
        for d, state in states.items():
            losses[d].append(float(train.train_step(state, batch, target)))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[dev], losses["cpu"]))
    print(f"(b) 3 train_steps of the full-width DenoiseCNN ({n_params} parameters, "
          f"{4 * n_params / 1e6:.1f} MB f32), batches of {TRAIN_BATCH} patches, cuda:0 vs the "
          f"CPU: losses {losses[dev]} vs {losses['cpu']} (worst rel {loss_rel:.3g}, <= "
          f"{LOSS_RTOL})")
    if not (np.isfinite(losses[dev] + losses["cpu"]).all() and loss_rel <= LOSS_RTOL):
        raise RuntimeError("the card's training losses disagree with the CPU's")
    got, want = states[dev].state_dict(), states["cpu"].state_dict()
    step_rel = max(hold_states("weights and BN statistics", got["model"], want["model"]),
                   hold_states("momentum buffers", got["momentum"], want["momentum"]))
    start = model0.state_dict()
    zero = {k: torch.zeros_like(v) for k, v in start.items()}
    step_l2 = update_l2(got["model"], want["model"], start)
    print(f"  the 3 steps moved the weights and statistics by "
          f"{1.0 / update_l2(zero, want['model'], start):.3g} of their norm; the card's update "
          f"is off by {step_l2:.3g} of its norm (<= {TRAIN_UPDATE_L2})")
    if not step_l2 <= TRAIN_UPDATE_L2:
        raise RuntimeError("the card's training update disagrees with the CPU's")

    simple = {d: create_simple_state(torch.Generator().manual_seed(0), ADAM_LR, d)
              for d in (dev, "cpu")}
    simple_start = {k: v.clone() for k, v in simple["cpu"][0].state_dict().items()}
    s_losses = {d: [] for d in simple}
    for i in range(3):
        batch = torch.from_numpy(inputs[TRAIN_BATCH * i: TRAIN_BATCH * (i + 1)])
        target = torch.from_numpy(targets[TRAIN_BATCH * i: TRAIN_BATCH * (i + 1)])
        for d, (model, opt) in simple.items():
            s_losses[d].append(float(simple_train_step(model, opt, batch, target)))
    s_rel = max(abs(a - b) / abs(b) for a, b in zip(s_losses[dev], s_losses["cpu"]))
    sd_dev = {k: v.cpu() for k, v in simple[dev][0].state_dict().items()}
    sd_cpu = simple["cpu"][0].state_dict()
    diff = torch.cat([(sd_dev[k] - v).abs().flatten() for k, v in sd_cpu.items()])
    off = float((diff > 1e-2 * ADAM_LR).float().mean())
    s_l2 = update_l2(sd_dev, sd_cpu, simple_start)
    print(f"(b) 3 simple_train_steps (Adam {ADAM_LR}), cuda:0 vs the CPU: summed losses worst "
          f"rel {s_rel:.3g} (<= {LOSS_RTOL}); the 3 steps' update off by {s_l2:.3g} of its "
          f"norm (<= {ADAM_UPDATE_L2}); parameters worst {float(diff.max()) / ADAM_LR:.3g} lr, "
          f"{off:.5f} of them beyond 1e-2 lr")
    if not (np.isfinite(s_losses[dev] + s_losses["cpu"]).all() and s_rel <= LOSS_RTOL
            and s_l2 <= ADAM_UPDATE_L2):
        raise RuntimeError("the card's simple_train_step disagrees with the CPU's")

    # (c) The training CLI: 4 epochs, a checkpoint and validation every 2,
    # then a resume of 1 epoch on each route, then CLI -d with the weights.
    device_flag = "cpu" if dev.type == "cpu" else str(dev.index)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        flags = ["--size", str(TRAIN_SIZE), "--poses", str(TRAIN_POSES), "--patch-size",
                 str(TRAIN_PATCH), "--patches-per-image", str(TRAIN_PER_IMAGE), "--spp-train",
                 str(TRAIN_SPP), "--spp-gt", str(TRAIN_SPP_GT), "--batch", str(TRAIN_BATCH),
                 "--ckpt-every", "2", "--plateau-patience", "1", "--device", device_flag]
        tk.CUDA_KERNEL.launches = 0
        t0 = time.perf_counter()
        rc = train.main(flags + ["--epochs", "4", "--name", "smoke"])
        main_s = time.perf_counter() - t0
        runs = glob.glob(os.path.join(tmp, "results", "*_smoke"))
        print(f"(c) train.main --epochs 4 --ckpt-every 2 --plateau-patience 1: exit {rc} in "
              f"{main_s:.2f} s, {tk.CUDA_KERNEL.launches} trace kernel launches")
        if rc != 0 or len(runs) != 1 or tk.CUDA_KERNEL.launches != 2 * TRAIN_POSES + 2:
            raise RuntimeError(f"train.main: exit {rc}, runs {runs}")
        run = runs[0]
        records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
        epochs = [r for r in records if r["event"] == "epoch"]
        vals = [r for r in records if r["event"] == "validate"]
        print(f"  epochs {[r['epoch'] for r in epochs]}, losses "
              f"{[round(r['loss'], 6) for r in epochs]}, lr {[r['lr'] for r in epochs]}; "
              f"validation PSNR {[(r['epoch'], round(r['psnr_db'], 4)) for r in vals]}")
        missing = [f for f in ("model.json", "model_epoch.pt", "model_best.pt", "best.json",
                               "metrics.jsonl", "2_gt.bmp", "2_out.bmp", "4_gt.bmp", "4_out.bmp")
                   if not os.path.isfile(os.path.join(run, f))]
        if [r["epoch"] for r in epochs] != [1, 2, 3, 4] or [r["epoch"] for r in vals] != [2, 4]:
            raise RuntimeError("metrics.jsonl lacks epoch or validate records")
        if missing or read_bmp(os.path.join(run, "4_out.bmp")).shape != (TRAIN_SIZE,
                                                                       TRAIN_SIZE, 3):
            raise RuntimeError(f"the run's directory lacks {missing}")
        if not epochs[-1]["loss"] < epochs[0]["loss"]:
            raise RuntimeError("the last epoch's loss is not below the first's")
        if not all(np.isfinite(r["psnr_db"]) for r in vals):
            raise RuntimeError("a validation PSNR is not finite")

        saved = torch.load(os.path.join(run, "model_epoch.pt"), weights_only=True)
        restored = train.load_train_state(run, device=dev)
        same = all(torch.equal(restored.momentum()[k].cpu(), v)
                   for k, v in saved["momentum"].items())
        print(f"  model_epoch.pt: epoch {saved['epoch']}, lr {saved['lr']}, plateau count "
              f"{saved['plateau_count']}; restored on {dev} with momentum buffers equal to "
              f"the saved ones: {same}")
        if saved["epoch"] != 4 or not same or restored.epoch != 4:
            raise RuntimeError("the checkpoint does not restore epoch 4 and its momentum")
        # The two routes from the restored state over the epoch's first three
        # minibatches (the same order): train_epoch on the dataset on the
        # card against loop_epoch, held as the card's steps against the
        # CPU's in (b).
        order3 = np.random.default_rng(0).permutation(n)[: 3 * TRAIN_BATCH]
        inputs_d = torch.from_numpy(inputs).to(dev)
        targets_d = torch.from_numpy(targets).to(dev)
        short = {}
        for label in ("loop", "scan"):
            st = train.load_train_state(run, device=dev)
            if label == "loop":
                train.loop_epoch(st, inputs, targets, order3, TRAIN_BATCH)
            else:
                train.train_epoch(st, inputs_d, targets_d, order3, TRAIN_BATCH)
            short[label] = st.state_dict()
        print(f"(c) 3 steps from the restored state, train_epoch (the dataset on the card) "
              f"against loop_epoch:")
        scan_rel = max(hold_states("weights and BN statistics", short["scan"]["model"],
                                   short["loop"]["model"]),
                       hold_states("momentum buffers", short["scan"]["momentum"],
                                   short["loop"]["momentum"]))
        scan_l2 = update_l2(short["scan"]["model"], short["loop"]["model"], saved["model"])
        print(f"  the update off by {scan_l2:.3g} of its norm (<= {TRAIN_UPDATE_L2})")
        if not scan_l2 <= TRAIN_UPDATE_L2:
            raise RuntimeError("train_epoch disagrees with loop_epoch on the card")

        # Then a whole epoch through the CLI on each route from the same
        # checkpoint, and the loop once more. The step is deterministic
        # (cuDNN's deterministic algorithms, the resize's matrix backward), so
        # the three runs must give the same bits; the update's spread is
        # printed and held against a gross fault too (SCAN_EPOCH_L2).
        loops = {}
        copies = {"loop": run, "loop again": shutil.copytree(run, run + "_again"),
                  "scan": shutil.copytree(run, run + "_scan")}
        for label, extra in (("loop", []), ("loop again", []), ("scan", ["--scan-epochs"])):
            path = copies[label]
            rc = train.main(flags + ["--resume", path, "--epochs", "1"] + extra)
            records = [json.loads(line) for line in open(os.path.join(path, "metrics.jsonl"))]
            last = [r for r in records if r["event"] == "epoch"][-1]
            loops[label] = torch.load(os.path.join(path, "model_epoch.pt"), weights_only=True)
            print(f"(c) --resume --epochs 1 {' '.join(extra)}: exit {rc}, epoch "
                  f"{last['epoch']}, loss {last['loss']:.7f}")
            if rc != 0 or last["epoch"] != 5 or loops[label]["epoch"] != 5:
                raise RuntimeError(f"the resumed run ({label}) did not continue at epoch 5")
        spread = {label: update_l2(loops[label]["model"], loops["loop"]["model"], saved["model"])
                  for label in ("loop again", "scan")}
        worst = {label: state_errors(loops[label]["model"], loops["loop"]["model"])[0]
                 for label in ("loop again", "scan")}
        print(f"  epoch 5's update against the loop's: the loop again off by "
              f"{spread['loop again']:.3g} of its norm (worst tensor {worst['loop again']:.3g} of "
              f"its largest value), --scan-epochs off by {spread['scan']:.3g} (<= "
              f"{SCAN_EPOCH_L2}; worst tensor {worst['scan']:.3g})")
        same = {label: all(torch.equal(loops[label][part][k], v)
                           for part in ("model", "momentum")
                           for k, v in loops["loop"][part].items())
                for label in ("loop again", "scan")}
        print(f"  the same bits as the loop's epoch (weights, statistics, momentum): the loop "
              f"again {same['loop again']}, --scan-epochs {same['scan']}")
        if not spread["scan"] <= SCAN_EPOCH_L2:
            raise RuntimeError("the --scan-epochs epoch is far from the loop's")
        if not all(same.values()):
            raise RuntimeError("the card's training step is not deterministic run to run")

        prefix = os.path.join(tmp, "den")
        tk.CUDA_KERNEL.launches = 0
        rc = cli.main(["-d", "--checkpoint", run, "--size", "512", "-s", "4", "--device",
                       device_flag, "--nobitmap", "-o", prefix])
        den = load_aovs_exr(prefix + ".exr")["color"]
        print(f"(c) CLI -d --checkpoint (the trained weights) 512x512x4: exit {rc}, "
              f"{tk.CUDA_KERNEL.launches} trace kernel launches, colour {den.shape}, finite "
              f"{bool(np.isfinite(den).all())}, mean {float(den.mean()):.4f}")
        if rc != 0 or den.shape != (512, 512, 3) or not np.isfinite(den).all():
            raise RuntimeError("CLI -d with the trained checkpoint failed")

        # Which backend wrote the EXRs and BMPs above; if native, its files
        # against the Python codec's.
        backend = "native" if native.available() else "python"
        print(f"(c) EXR/BMP writes took the {backend} backend (libptio: "
              f"{native.library_path().name if backend == 'native' else 'not built'})")
        if backend == "native":
            chans = {"A": np.random.default_rng(1).normal(size=(37, 29)).astype(np.float32),
                     "B": np.full((37, 29), 0.5, np.float32)}
            write_exr(os.path.join(tmp, "n.exr"), chans, backend="native")
            back = read_exr(os.path.join(tmp, "n.exr"), backend="python")
            img = np.clip(vgt[..., 0:3], 0, 1)
            write_bmp(os.path.join(tmp, "n.bmp"), img, backend="native")
            with open(os.path.join(tmp, "n.bmp"), "rb") as f:
                bmp_same = f.read() == encode_bmp(img)
            exr_same = all(np.array_equal(back[k], v) for k, v in chans.items())
            print(f"  native EXR read back by the Python reader: equal {exr_same}; native BMP "
                  f"= the Python BMP, byte for byte: {bmp_same}")
            if not (exr_same and bmp_same):
                raise RuntimeError("the native IO disagrees with the Python codec")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) Times by CUDA events after warm-up; the step's device time and
    # idle share by torch.profiler; the step's bound.
    state = restored
    batch = torch.from_numpy(inputs[:TRAIN_BATCH]).to(dev)
    target = torch.from_numpy(targets[:TRAIN_BATCH]).to(dev)
    times = {}
    times["step"], _ = time_fn(lambda: train.train_step(state, batch, target), warmup=3,
                               iters=STEP_ITERS, device=dev)
    order = np.random.default_rng(0).permutation(n)
    times["loop_epoch"], _ = time_fn(
        lambda: train.loop_epoch(state, inputs, targets, order, TRAIN_BATCH), warmup=1,
        iters=EPOCH_ITERS, device=dev)
    times["scan_epoch"], _ = time_fn(
        lambda: train.train_epoch(state, inputs_d, targets_d, order, TRAIN_BATCH), warmup=1,
        iters=EPOCH_ITERS, device=dev)
    med = {k: statistics.median(v) for k, v in times.items()}
    step_device_ms, step_idle = profile_steps(
        "train_step", lambda s: (s, train.train_step(s, batch, target)), state, med["step"])
    x = batch
    n_ops = 3 * cnn_operations(copy.deepcopy(state.model).eval(), x)
    param_bytes = 4 * n_params
    stat_bytes = 4 * sum(b.numel() for b in state.model.buffers() if b.dtype == torch.float32)
    io_bytes = 4 * (batch.numel() + target.numel())
    # The step's function: weights, momentum and BN statistics read once and
    # written once, the batch and target read once.
    n_bytes = 4 * param_bytes + 2 * stat_bytes + io_bytes
    ops_ms = 1e3 * n_ops / PUBLISHED_F32_FLOPS
    bytes_ms = 1e3 * n_bytes / PUBLISHED_BYTES_PER_S
    eager_ms = 1e3 * (8 * param_bytes + 2 * stat_bytes + io_bytes) / PUBLISHED_BYTES_PER_S
    n_steps = n // TRAIN_BATCH
    print(f"(d) card: {smi}; CUDA events, median after warm-up (runs min..max):")
    print(f"  train_step (batch {TRAIN_BATCH}, {TRAIN_PATCH}x{TRAIN_PATCH}, full width, f32): "
          f"{med['step']:.4f} ms ({min(times['step']):.4f}..{max(times['step']):.4f}) of "
          f"{STEP_ITERS}; device {step_device_ms:.4f} ms (profiler), idle {step_idle:.3f}")
    for key, label in (("loop_epoch", "loop route (loop_epoch)"),
                       ("scan_epoch", "--scan-epochs route (train_epoch)")):
        print(f"  epoch, {label}, {n_steps} steps: {med[key]:.4f} ms "
              f"({min(times[key]):.4f}..{max(times[key]):.4f}) of {EPOCH_ITERS}; "
              f"{med[key] / n_steps:.4f} ms a step")
    print(f"  bound of a step: operations 3 x {n_ops // 3} (the forward's convolutions, a "
          f"multiply-add as two) = {n_ops} / {PUBLISHED_F32_FLOPS / 1e12:.0f} TFLOP/s = "
          f"{ops_ms:.4f} ms; bytes {n_bytes} (weights and momentum read and written once: 4 x "
          f"{param_bytes}, BN statistics {2 * stat_bytes}, batch and target {io_bytes}) / "
          f"{PUBLISHED_BYTES_PER_S / 1e12:.2f} TB/s = {bytes_ms:.4f} ms; bound "
          f"{max(ops_ms, bytes_ms):.4f} ms by {'operations' if ops_ms >= bytes_ms else 'bytes'}"
          f", share {max(ops_ms, bytes_ms) / med['step']:.3f} by events, "
          f"{max(ops_ms, bytes_ms) / step_device_ms:.3f} by device time; the eager step's 8 "
          f"passes over the weights would take {eager_ms:.4f} ms")
    print(f"(a)-(c) held: the {TRAIN_SPP_GT}-spp launch max |diff| {gt_err}; the card's 3 steps "
          f"against the CPU's {step_rel:.3g} of a tensor's largest value (<= {TRAIN_REL}), "
          f"update {step_l2:.3g} (<= {TRAIN_UPDATE_L2}); train_epoch against loop_epoch on the "
          f"card {scan_rel:.3g} of a tensor's largest value, update {scan_l2:.3g} (<= "
          f"{TRAIN_UPDATE_L2})")
    return med


GRID_SIZE, GRID_SPP = 512, 32  # the bench frame
GRID_SPLITS = ((4, 1), (2, 2), (1, 4))
GRID_ROUTES = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"},
               "nee_glossy": {"nee": True, "brdf": "glossy"}}
GRID_GRAD_SPP = 8
GRID_DENOISE_SIZE = 1024
GRID_ITERS = 10
GRID_MEAN_TOL = 1e-4  # rtol and atol of the mean channels (tests/test_sharding.py)
GRID_VAR_ATOL = 2e-3  # each variance channel scaled by its largest value
GRID_LOSS_RTOL = 1e-5
GRID_GRAD_RTOL, GRID_GRAD_ATOL = 1e-3, 1e-4  # atol: a share of the field's largest entry
GRID_FPN_RTOL, GRID_FPN_ATOL = 1e-5, 2e-5  # tests/test_spatial.py
GRID_SIMPLE_ATOL = 1e-5  # times max(1, the largest output)
# The sharded FPN at 1024x1024 (full widths, TF32 off), for each of the
# weight seeds: max |sharded - f64 forward| and max |sharded - whole-frame
# f32 forward| at most these, and at most GRID_FPN_MAX_BEYOND of the
# 3,145,728 outputs beyond tests/test_spatial.py's rtol + atol. Set from the
# readings over the three seeds on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md, PR 9): |sharded - f64| 3.0e-5..3.95e-5 and the whole frame's
# own f32 |whole - f64| 2.6e-5..6.67e-5, |sharded - whole| 2.74e-5..3.47e-5
# with 4..10 outputs beyond; cuDNN's choice of algorithms moves them from
# run to run, so the limits leave 1.5x the largest f32 reading. The TF32
# control reads 0.051..0.058 against f64, 500x the limit.
GRID_FPN_SEEDS = (0, 1, 2)
GRID_FPN_F64_LIMIT = 1e-4
GRID_FPN_WHOLE_LIMIT = 1e-4
GRID_FPN_MAX_BEYOND = 64


def grid_frame_errors(label, out, ref):
    """Hold a frame rendered on a grid against the single-device frame
    (tests/test_sharding.py's tolerances); print one line; raise on a
    breach. -> the largest |difference| of the mean channels."""
    out = out.detach().cpu().double().numpy()
    ref = ref.detach().cpu().double().numpy()
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise RuntimeError(f"{label}: shape {out.shape} against {ref.shape}, or non-finite")
    d = np.abs(out[..., :10] - ref[..., :10])
    mean_ok = bool(np.all(d <= GRID_MEAN_TOL + GRID_MEAN_TOL * np.abs(ref[..., :10])))
    var_err = max(float(np.abs(out[..., c] - ref[..., c]).max()
                        / max(np.abs(ref[..., c]).max(), 1e-3)) for c in range(10, 14))
    bits = bool(np.array_equal(out, ref))
    print(f"  {label}: means max |diff| {d.max():.3g} (rtol/atol {GRID_MEAN_TOL}), variances "
          f"max scaled |diff| {var_err:.3g} (atol {GRID_VAR_ATOL}); bits equal to the "
          f"single-device frame: {'yes' if bits else 'no'}")
    if not (mean_ok and var_err <= GRID_VAR_ATOL):
        raise RuntimeError(f"{label}: the grid's frame is not the single-device frame")
    return float(d.max())


def grid_grad_errors(label, got, want):
    """Hold a grid's loss and gradients against the single-device ones: loss
    rtol 1e-5, each field rtol 1e-3 plus 1e-4 of its largest entry
    (tests/test_sharding.py); print one line; raise on a breach."""
    loss_err = abs(got["loss"] / want["loss"] - 1.0)
    worst, worst_name = 0.0, None
    ok = loss_err <= GRID_LOSS_RTOL
    for name, w in want["grads"].items():
        g = got["grads"][name]
        scale = max(float(np.abs(w).max()), 1e-12)
        excess = np.abs(g - w) - GRID_GRAD_RTOL * np.abs(w) - GRID_GRAD_ATOL * scale
        ok = ok and bool(np.all(np.isfinite(g)) and np.all(excess <= 0))
        err = float(np.abs(g - w).max() / scale)
        if err >= worst:
            worst, worst_name = err, name
    print(f"  {label}: loss {got['loss']:.6g} against {want['loss']:.6g} (rel {loss_err:.3g}); "
          f"worst field {worst_name}, max |diff| {worst:.3g} of its largest entry")
    if not ok:
        raise RuntimeError(f"{label}: the grid's loss or gradients are not the single device's")


def sums_of_block(block, n):
    """A gradient block [N + 5, 11] -> the flat sums [10N + 16] it was made
    of (``nee_grad_kernel.block_from_sums`` undone)."""
    import torch
    from pathtrace_tpu_torch.ops.nee_grad_kernel import LOSS_COL

    return torch.cat([block[:n, :10].reshape(-1), block[n, 0:3],
                      block[n + 1: n + 5, 0:3].reshape(-1), block[n, LOSS_COL:LOSS_COL + 1]])


def grid_grad_slab_checks(dev, scene, cam, grad_cfgs, world):
    """Each rank's backward launch of each route (``"grad_slab"``: at the
    grid's shapes, row and sample offsets and sample lanes) against its plain
    version on cuda:0 on the same seed block and cotangent: the K2 dump's
    colour and accumulators under phase 6's rules, the K3 and K4 blocks under
    phases 9 and 13's. Prints a line a route; raises on a breach. ->
    {kernel: max |kernel - plain|}."""
    import torch
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
    from pathtrace_tpu_torch.ops import trace_kernel as tk

    n = scene.num_objects
    sb = scene.packed().to(dev)
    names = {"chain": "grad_kernel[dump]", "nee": "nee_grad_kernel[replay]",
             "ad": "ad_grad_kernel"}
    errs = {}
    for j, route in enumerate(grad_cfgs):
        cfg = grad_cfgs[route]
        cb = tk.camera_block(cam, cfg).to(dev)
        bits, worst = [], 0.0
        for r in world:
            got = r["grad_slabs"][j]
            kw = dict(local_h=got["local_h"], spp=got["spp"], device=dev)
            seed = got["seed"]
            label = f"{route} rank {r['rank']} ({got['local_h']} rows, {got['spp']} spp)"
            if got["route"] == "chain":
                color, acc = gk.dump_plain(sb, cb, seed, cfg, **kw)
                worst = max(worst,
                            grad_compare(f"{label} dump/colour", got["color"], color.cpu(),
                                         "color"),
                            grad_compare(f"{label} dump/acc", got["acc"], acc.cpu(), "acc"))
                bits.append(bool(torch.equal(got["color"], color.cpu())
                                 and torch.equal(got["acc"], acc.cpu())))
                continue
            ct = got["ct"].to(dev)
            if got["route"] == "nee":
                sums = nk.replay_plain(sb, cb, seed, cfg, ct.permute(1, 2, 0).contiguous(),
                                       **kw)
            else:
                sums = ak.replay_plain(sb, cb, seed, cfg, ct.contiguous(), **kw)
            flat = sums_of_block(got["block"], n)
            worst = max(worst, nee_compare(f"{label} block", flat, sums.cpu(), "sums"))
            bits.append(bool(torch.equal(flat, sums.cpu())))
        name = names[world[0]["grad_slabs"][j]["route"]]
        errs[name] = max(errs.get(name, 0.0), worst)
        print(f"  {route}: each rank's {name} launch = its plain version on the same inputs "
              f"(max |diff| {worst:.3g}); bits equal, by rank: {bits}")
    return errs


def grid_phase_20(dev, tk, smi):
    """Rendering and loss+gradients on a ("tiles", "samples") grid of ranks,
    and the row-sharded denoisers, with several ranks sharing the one card:
    the decomposition's correctness, not scaling. Raises on any failure. ->
    (the ranks' launches of each kernel on the grid's main path, summed;
    {kernel: max |kernel - plain|} of the ranks' backward launches)."""
    import contextlib
    import io

    import torch
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import grad as port_grad
    from pathtrace_tpu_torch.convert import grads_to_numpy
    from pathtrace_tpu_torch.models.denoise_cnn import DEFAULT_WIDTHS, cudnn_tf32
    from pathtrace_tpu_torch.models.preprocess import preprocess_channels
    from pathtrace_tpu_torch.parallel import scaling
    from pathtrace_tpu_torch.parallel.dryrun import dryrun_multichip
    from pathtrace_tpu_torch.parallel.launch import launch
    from pathtrace_tpu_torch.parallel.selfcheck import KERNEL_COUNTERS, build_model, card_world
    from pathtrace_tpu_torch.render import render_channels

    phase(20, "the (tiles, samples) grid: 4 ranks (gloo) sharing cuda:0 render 512x512x32 on "
              "(4,1), (2,2), (1,4), take loss+gradients at 512x512x8 on (2,2) for the four "
              "kernel routes, and denoise a 1024x1024 frame as slabs on (4,1); 1 rank on NCCL; "
              "dryrun_multichip(4); the scaling record")
    scene, cam = cornell_box(), Camera.create()
    bench = RenderConfig(width=GRID_SIZE, height=GRID_SIZE, spp=GRID_SPP, backend="cuda")
    big = RenderConfig(width=GRID_DENOISE_SIZE, height=GRID_DENOISE_SIZE, spp=4, backend="cuda")
    target = np.random.default_rng(0).uniform(size=(GRID_SIZE, GRID_SIZE, 3)).astype(
        np.float32)
    grad_cfgs = {r: RenderConfig(width=GRID_SIZE, height=GRID_SIZE, spp=GRID_GRAD_SPP,
                                 backend="cuda", **x) for r, x in GRID_ROUTES.items()}
    simple = {"kind": "simple", "features": 64, "depth": 4, "seed": 0}
    fpns = [{"kind": "fpn", "widths": DEFAULT_WIDTHS, "seed": k} for k in GRID_FPN_SEEDS]
    denoise = dict(kind="render_denoise", grid=(4, 1), scene=scene, cam=cam, cfg=big,
                   simple=simple, fpn=fpns)
    cases = [dict(kind="render", grid=g, scene=scene, cam=cam, cfg=bench) for g in GRID_SPLITS]
    cases += [dict(kind="grads", grid=(2, 2), scene=scene, cam=cam, cfg=grad_cfgs[r],
                   target=torch.from_numpy(target)) for r in GRID_ROUTES]
    cases.append(denoise)
    grad_checks = [dict(case, kind="grad_slab") for case in cases if case["kind"] == "grads"]
    t0 = time.perf_counter()
    world4 = launch(card_world, 4, cases,
                    slab_checks=[(scene, cam, bench, g) for g in GRID_SPLITS],
                    grad_checks=grad_checks, timings=[("fpn", [denoise])],
                    scaling=(scene, cam, bench, [1, 2, 4]),
                    iters=GRID_ITERS)
    print(f"world of 4 ranks on cuda:0: backends {sorted({r['backend'] for r in world4})}, "
          f"{time.perf_counter() - t0:.1f} s with its start")
    res = [r["results"] for r in world4]

    # (a) The bench frame on three grids against the single-device entry point.
    print("(a) the bench frame 512x512x32 on each grid against render_channels on cuda:0:")
    ref = render_channels(scene, cam, bench, device=dev)
    for j, grid in enumerate(GRID_SPLITS):
        if not all(torch.equal(r[j], res[0][j]) for r in res):
            raise RuntimeError(f"grid {grid}: the ranks hold different frames")
        grid_frame_errors(f"grid {grid}", res[0][j], ref)
    sb, cb = scene.packed(), tk.camera_block(cam, bench)
    for j, grid in enumerate(GRID_SPLITS):
        lanes = []
        for r in world4:
            slab = r["slabs"][j]
            plain = tk.trace_plain(sb, cb, slab["seed"], bench, local_h=slab["local_h"],
                                   spp=slab["spp"], mode="partials", device=dev)
            if not torch.equal(plain.cpu(), slab["partials"]):
                raise RuntimeError(f"grid {grid}, rank {r['rank']}: the slab launch is not its "
                                   "plain version to the bit")
            lanes.append(slab["lanes"])
        print(f"  grid {grid}: each rank's slab launch ({slab['local_h']} rows, {slab['spp']} "
              f"spp, sample lanes {lanes}) = its plain version to the bit")

    # (b) Loss and gradients of the four kernel routes on (2, 2).
    print(f"(b) loss+gradients 512x512x{GRID_GRAD_SPP} on (2,2) against render_loss_grads on "
          "cuda:0:")
    for k, route in enumerate(GRID_ROUTES, start=len(GRID_SPLITS)):
        if not all(r[k]["loss"] == res[0][k]["loss"] for r in res):
            raise RuntimeError(f"{route}: the ranks hold different losses")
        loss, grads = port_grad.render_loss_grads(scene, cam, grad_cfgs[route], 0, target,
                                                  device=dev)
        grid_grad_errors(route, res[0][k], {"loss": float(loss),
                                            "grads": grads_to_numpy(*grads)})
    errs = grid_grad_slab_checks(dev, scene, cam, grad_cfgs, world4)

    # (c) A 1024x1024 frame rendered as slabs, preprocessed and denoised on them.
    print(f"(c) {GRID_DENOISE_SIZE}x{GRID_DENOISE_SIZE}x{big.spp} on (4,1) into "
          "denoise_fpn_sharded (full widths) and denoise_spatially_sharded:")
    out = res[0][-1]
    grid_frame_errors("frame", out["frame"], render_channels(scene, cam, big, device=dev))
    x = preprocess_channels(out["frame"].to(dev))
    if not torch.equal(out["input"], x.cpu()):
        raise RuntimeError("the slabs' preprocessing is not the whole frame's")
    model = build_model(simple, dev)
    with torch.no_grad(), cudnn_tf32(False):
        full = model(x[None])[0].cpu()
    atol = GRID_SIMPLE_ATOL * max(1.0, float(full.abs().max()))
    diff = (out["simple"] - full).abs()
    beyond = int((diff > atol + GRID_FPN_RTOL * full.abs()).sum())
    print(f"  simple: max |sharded - whole frame| {float(diff.max()):.3g}, {beyond} of "
          f"{diff.numel()} beyond rtol {GRID_FPN_RTOL} + atol {atol:.3g}; output range "
          f"{float(full.min()):.4g}..{float(full.max()):.4g}")
    if beyond:
        raise RuntimeError("simple: the sharded denoiser is not the whole frame's")
    failed = []
    for spec, got in zip(fpns, out["fpn"]):
        # The whole frame's forward in f32 (TF32 off, as the ranks run it),
        # in TF32 (the control: a fault of that size must show) and in f64,
        # the exact result of the same weights.
        model = build_model(spec, dev)
        with torch.no_grad():
            with cudnn_tf32(False):
                full = model(x[None])[0].cpu()
            with cudnn_tf32(True):
                tf32 = model(x[None])[0].cpu()
            exact = model.double()(x.double()[None])[0].cpu()
        diff = (got - full).abs()
        beyond = int((diff > GRID_FPN_ATOL + GRID_FPN_RTOL * full.abs()).sum())
        err = {name: float((y.double() - exact).abs().max())
               for name, y in (("sharded", got), ("whole", full), ("tf32", tf32))}
        tf32_whole = float((tf32 - full).abs().max())
        print(f"  fpn seed {spec['seed']}: max |sharded - whole frame f32| "
              f"{float(diff.max()):.3g} (limit {GRID_FPN_WHOLE_LIMIT}), {beyond} of "
              f"{diff.numel()} beyond rtol {GRID_FPN_RTOL} + atol {GRID_FPN_ATOL} (at most "
              f"{GRID_FPN_MAX_BEYOND}); max |y - f64 forward|: sharded {err['sharded']:.3g} "
              f"(limit {GRID_FPN_F64_LIMIT}), whole frame f32 {err['whole']:.3g}, control TF32 "
              f"{err['tf32']:.3g} (|TF32 - whole f32| {tf32_whole:.3g}); output range {float(full.min()):.4g}.."
              f"{float(full.max()):.4g}")
        if not (err["sharded"] <= GRID_FPN_F64_LIMIT
                and float(diff.max()) <= GRID_FPN_WHOLE_LIMIT and beyond <= GRID_FPN_MAX_BEYOND):
            failed.append(f"seed {spec['seed']}: the sharded output is off")
        if not err["tf32"] > GRID_FPN_F64_LIMIT:
            failed.append(f"seed {spec['seed']}: the TF32 control passes the f64 limit")
    if failed:
        raise RuntimeError(f"fpn: {'; '.join(failed)}")

    # (d) One rank on NCCL: the render and the NEE route, and the grid's own
    # cost beside the single-device entry point.
    t0 = time.perf_counter()
    nccl_cases = [dict(kind="render", grid=(1, 1), scene=scene, cam=cam, cfg=bench),
                  dict(kind="grads", grid=(1, 1), scene=scene, cam=cam, cfg=grad_cfgs["nee"],
                       target=torch.from_numpy(target))]
    world1 = launch(card_world, 1, nccl_cases, backend="nccl",
                    timings=[("grid", [nccl_cases[0], dict(nccl_cases[0], kind="single")])],
                    iters=GRID_ITERS)[0]
    if world1["backend"] != "nccl":
        raise RuntimeError(f"the world of one rank ran on {world1['backend']}, not nccl")
    print(f"(d) a world of 1 rank on {world1['backend']} ({time.perf_counter() - t0:.1f} s with "
          "its start):")
    grid_frame_errors("grid (1,1)", world1["results"][0], ref)
    loss, grads = port_grad.render_loss_grads(scene, cam, grad_cfgs["nee"], 0, target,
                                              device=dev)
    grid_grad_errors("nee (1,1)", world1["results"][1],
                     {"loss": float(loss), "grads": grads_to_numpy(*grads)})

    # (e) The dry run and the scaling record.
    t0 = time.perf_counter()
    dry = dryrun_multichip(4)
    print(f"(e) dryrun_multichip(4): meshes {dry[0]['mesh']}, loss {dry[0]['loss']:.6g}, NEE "
          f"loss {dry[0]['loss_nee']:.6g}, the CNN's split step (dryrun_cnn_dp) "
          f"{dry[0]['loss_cnn_dp']:.6g} on every rank ({time.perf_counter() - t0:.1f} s)")
    if any(r["loss_cnn_dp"] != dry[0]["loss_cnn_dp"] for r in dry):
        raise RuntimeError("dryrun_cnn_dp: the ranks hold different losses")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scaling.main(["--json", "--iters", str(GRID_ITERS)])
    record = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  scaling record: {json.dumps(record)}")
    if record["gate_80pct"] is not None or record["num_devices"] != torch.cuda.device_count():
        raise RuntimeError("the scaling record of one card must carry a null gate")

    times, rows = world4[0]["times"], world4[0]["scaling"]
    grid_ms, single_ms = world1["times"]["grid"]
    cost = [g - o for g, o in zip(grid_ms, single_ms)]
    print(f"card: {smi}; CUDA events, {GRID_ITERS} turns after a warm-up (median, and "
          "min..max):")
    print(f"  512x512x32, 1 rank on NCCL, called in turns: sharded render on (1,1) "
          f"{statistics.median(grid_ms):.4f} ms ({min(grid_ms):.4f}..{max(grid_ms):.4f}), "
          f"single-device render_channels {statistics.median(single_ms):.4f} ms "
          f"({min(single_ms):.4f}..{max(single_ms):.4f}); the grid's own cost, a turn's "
          f"difference: {statistics.median(cost):.4f} ms ({min(cost):.4f}..{max(cost):.4f})")
    print("  512x512x32 on the first 1, 2, 4 ranks of the gloo world, median of "
          f"{GRID_ITERS} (ranks share one card: not a scaling figure): " + ", ".join(
              f"{r['ranks']} rank(s) {r['mesh']} {1e3 * r['seconds']:.4f} ms" for r in rows))
    fpn_ms = times["fpn"][0]
    print(f"  denoise_fpn_sharded {GRID_DENOISE_SIZE}x{GRID_DENOISE_SIZE} on (4,1), 4 ranks "
          f"sharing one card (rank 0): {statistics.median(fpn_ms):.4f} ms ({min(fpn_ms):.4f}.."
          f"{max(fpn_ms):.4f})")

    launches = {k: sum(r["launches"][k] for r in world4) + world1["launches"][k]
                for k in KERNEL_COUNTERS}
    print(f"launches on the grid's main path, summed over the ranks: {launches}")
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"the grid's main path did not launch {name}")
    return launches, errs


# ---- the denoiser's batch data parallelism (phase 21) -----------------------------

DP_POSES, DP_SIZE, DP_SPP_GT, DP_PER_IMAGE = 4, 256, 64, 16
DP_RANKS, DP_BATCH, DP_STEPS, DP_ITERS = 4, 8, 3, 10
# The world's steps against the same steps on cuda:0 on the whole batch:
# losses within rtol DP_LOSS_RTOL, and every update (weights, BatchNorm
# statistics, momentum) within DP_UPDATE_L2 of its norm (phase 19 (c)'s
# bound: the split sums each rank's gradients apart, then adds the ranks'
# sums, another order than one device's). The ranks among themselves: to
# the bit.
DP_LOSS_RTOL, DP_UPDATE_L2 = 1e-4, 0.1


def dp_phase_21(dev, tk, smi):
    """The denoiser trainer's batch split over ranks sharing the one card:
    a dataset through K1, then 4 gloo ranks (and 1 NCCL rank) against
    cuda:0. Raises on any failure. -> K1's launches on the dataset."""
    import copy

    import torch
    from pathtrace_tpu_torch import RenderConfig, cornell_box, train
    from pathtrace_tpu_torch.models import init_model
    from pathtrace_tpu_torch.parallel.launch import launch
    from pathtrace_tpu_torch.parallel.selfcheck import dp_world

    phase(21, f"batch data parallelism: a dataset of {DP_POSES} poses at {DP_SIZE}x{DP_SIZE} "
              f"through K1; {DP_RANKS} gloo ranks sharing cuda:0 train the full-width CNN on "
              f"batches of {DP_BATCH} ({DP_BATCH // DP_RANKS} a rank) against cuda:0; a fit "
              "epoch in the world; 1 rank on NCCL")
    t_phase = time.perf_counter()
    # (a) The dataset, the launch count set to 0 just before and read after.
    cfg = RenderConfig(width=DP_SIZE, height=DP_SIZE, spp=2, backend="auto")
    tk.CUDA_KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inputs, targets = train.build_dataset(cornell_box(), cfg, n_poses=DP_POSES,
                                          patch_size=TRAIN_PATCH, patches_per_image=DP_PER_IMAGE,
                                          spp_train=TRAIN_SPP, spp_gt=DP_SPP_GT, seed=0,
                                          device=dev)
    dataset_s = time.perf_counter() - t0
    launches = tk.CUDA_KERNEL.launches
    print(f"(a) build_dataset: {launches} trace kernel launches (want {2 * DP_POSES}), "
          f"{dataset_s:.2f} s; inputs {inputs.shape}, targets {targets.shape}")
    if launches != 2 * DP_POSES or inputs.shape != (DP_POSES * DP_PER_IMAGE, TRAIN_PATCH,
                                                     TRAIN_PATCH, 14):
        raise RuntimeError(f"the dataset took {launches} launches, shape {inputs.shape}")
    if not (np.isfinite(inputs).all() and np.isfinite(targets).all()):
        raise RuntimeError("the dataset holds non-finite values")

    # (b)-(c) and the times in one world of 4 gloo ranks on the card.
    start = train.create_state(init_model(torch.Generator().manual_seed(0)), "cpu")
    payload = train.state_payload(start)
    batches = [(torch.from_numpy(inputs[DP_BATCH * i: DP_BATCH * (i + 1)]),
                torch.from_numpy(targets[DP_BATCH * i: DP_BATCH * (i + 1)]))
               for i in range(DP_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        fit_kwargs = dict(epochs=1, batch_size=DP_BATCH, seed=0, log_every=1, ckpt_dir=tmp,
                          ckpt_every=1, scan_epochs=True)
        cases = [dict(kind="steps", model=payload, batches=batches),
                 dict(kind="fit", model=payload, inputs=inputs, targets=targets,
                      metrics=os.path.join(tmp, "metrics.jsonl"), kwargs=fit_kwargs)]
        t0, wall0 = time.perf_counter(), time.time()
        world = launch(dp_world, DP_RANKS, cases,
                       timing=(payload, batches[0][0], batches[0][1], DP_ITERS))
        world_s = time.perf_counter() - t0
        print(f"world of {DP_RANKS} ranks on cuda:0: backends "
              f"{sorted({r['backend'] for r in world})}, {world_s:.1f} s with its start (the "
              f"ranks entered after {max(r['entered'] for r in world) - wall0:.1f} s; rank 0's "
              f"steps {world[0]['seconds'][0]:.1f} s, fit {world[0]['seconds'][1]:.1f} s)")
        if {r["backend"] for r in world} != {"gloo"}:
            raise RuntimeError("the shared-card world did not run on gloo")
        steps = [r["results"][0] for r in world]
        fits = [r["results"][1] for r in world]
        records = [json.loads(line) for line in open(os.path.join(tmp, "metrics.jsonl"))]
        saved = torch.load(train.checkpoint_file(tmp), weights_only=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # The same steps on cuda:0 on the whole batch, from the same weights.
    single = train.create_state(copy.deepcopy(start.model), dev)
    single_losses = [float(train.train_step(single, x, y)) for x, y in batches]
    want = single.state_dict()
    ref = steps[0]

    def bit_equal(results):
        return all(r["state"]["model"][k].equal(v) for r in results[1:]
                   for k, v in results[0]["state"]["model"].items()) and all(
            r["state"]["momentum"][k].equal(v) for r in results[1:]
            for k, v in results[0]["state"]["momentum"].items())

    same_ranks = bit_equal(steps) and all(r["losses"] == ref["losses"] for r in steps)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ref["losses"], single_losses))
    start_sd = start.state_dict()
    l2 = {part: update_l2(ref["state"][part], want[part], start_sd[part])
          for part in ("model", "momentum")}
    print(f"(b) {DP_STEPS} train_steps, batch {DP_BATCH} over {DP_RANKS} ranks against cuda:0 "
          f"on the whole batch: losses {ref['losses']} vs {single_losses} (worst rel "
          f"{loss_rel:.3g}, <= {DP_LOSS_RTOL}); the update off by {l2['model']:.3g} of its norm "
          f"(weights and BatchNorm statistics), {l2['momentum']:.3g} (momentum) (<= "
          f"{DP_UPDATE_L2}); every rank's losses, weights, statistics and momentum rank 0's "
          f"bits: {same_ranks}")
    if not (np.isfinite(ref["losses"]).all() and loss_rel <= DP_LOSS_RTOL):
        raise RuntimeError("the data-parallel losses disagree with one device's")
    if not max(l2.values()) <= DP_UPDATE_L2:
        raise RuntimeError("the data-parallel update disagrees with one device's")
    if not same_ranks:
        raise RuntimeError("the ranks' states differ: the all-reduce handed them different sums")

    histories = [r["history"] for r in fits]
    epochs = [r["epoch"] for r in records if r["event"] == "epoch"]
    n_steps = inputs.shape[0] // DP_BATCH
    print(f"(c) fit, 1 epoch of {n_steps} steps, --scan-epochs route, in the world: histories "
          f"{histories}; metrics records {epochs}; model_epoch.pt at epoch {saved['epoch']}; "
          f"the ranks' states equal to the bit: {bit_equal(fits)}")
    if any(h != histories[0] for h in histories) or not np.isfinite(histories[0]).all():
        raise RuntimeError("the ranks of fit returned different or non-finite histories")
    if epochs != [1] or saved["epoch"] != 1 or not bit_equal(fits):
        raise RuntimeError("fit in the world did not write one epoch's files once")

    # (d) A world of one rank on NCCL: the same first step split over it.
    t0, wall0 = time.perf_counter(), time.time()
    one = launch(dp_world, 1, [dict(kind="steps", model=payload, batches=batches[:1],
                                    whole_world=True)], backend="nccl")[0]
    one_s = time.perf_counter() - t0
    nccl = one["results"][0]
    first = train.create_state(copy.deepcopy(start.model), dev)
    train.train_step(first, *batches[0])
    one_l2 = update_l2(nccl["state"]["model"], first.state_dict()["model"], start_sd["model"])
    print(f"(d) a world of 1 rank on {one['backend']} ({one_s:.1f} s with its start, entered "
          f"after {one['entered'] - wall0:.1f} s, the step {one['seconds'][0]:.1f} s): one split "
          f"step, loss {nccl['losses'][0]} vs cuda:0 {single_losses[0]}, the "
          f"update off by {one_l2:.3g} of its norm (<= {DP_UPDATE_L2})")
    if one["backend"] != "nccl" or abs(nccl["losses"][0] - single_losses[0]) > DP_LOSS_RTOL * abs(
            single_losses[0]) or not one_l2 <= DP_UPDATE_L2:
        raise RuntimeError("the NCCL rank's split step disagrees with one device's")

    times = world[0]["times"]
    med = {k: statistics.median(v) for k, v in times.items()}
    n_params = sum(p.numel() for p in start.model.parameters())
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in start.model.modules())
    print(f"card: {smi}; CUDA events on rank 0, {DP_ITERS} turns after a warm-up (median, "
          "min..max), the ranks sharing one card (not a scaling figure):")
    print(f"  train_step split over {DP_RANKS} gloo ranks, batch {DP_BATCH}: {med['dp']:.4f} ms "
          f"({min(times['dp']):.4f}..{max(times['dp']):.4f}); one device, the whole batch, "
          f"called in turns: {med['single']:.4f} ms ({min(times['single']):.4f}.."
          f"{max(times['single']):.4f}); the split step's all-reduce carries {n_params + 1} f32 "
          f"({4 * (n_params + 1) / 1e6:.1f} MB) through the host, and {2 * n_bn} small all-reduces "
          f"of BatchNorm's sums ({n_bn} layers, forward and backward)")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- the gradient gate (phase 22) -----------------------------------------------

# The JAX package's gate configuration (docs/GRAD_GATE.md): Cornell 512^2 x 32
# spp, NEE; the FD probes at 8 spp of the same lattice.
GATE_ARGS = ("--size", "512", "--spp", "32")


def gate_phase_22():
    """Run the gate's two scripts on cuda:0; raise on a non-zero exit or a
    FAIL."""
    phase(22, "the gradient gate at 512x512x32 NEE on cuda:0: the f64 frozen-decision oracle "
              "(scripts/torch_grad_oracle.py), then K2, K3 and K4 against it "
              "(scripts/torch_grad_gate.py)")
    t0 = time.perf_counter()
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    try:
        oracle = os.path.join(tmp, "oracle.npz")
        report = os.path.join(tmp, "GRAD_GATE_H100.md")
        for script, extra in (("torch_grad_oracle.py", ("--fd-spp", "8", "--out", oracle)),
                              ("torch_grad_gate.py", ("--oracle", oracle, "--out", report))):
            ts = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.join(scripts, script), *GATE_ARGS,
                                   *extra, "--device", "0"], capture_output=True, text=True,
                                  timeout=900)
            lines = proc.stdout.splitlines()
            shown = [line for line in lines if line.startswith(("[", "| ", "**Overall"))]
            paragraph = [line for line in "\n".join(lines).split("\n\n")
                         if line.startswith("Record-point")]
            for line in shown + [" ".join(p.split()) for p in paragraph]:
                print(f"  {line}")
            print(f"  {script}: exit {proc.returncode} after {time.perf_counter() - ts:.1f} s")
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"{script} exited {proc.returncode}")
        if "**Overall: PASS**" not in open(report).read():
            raise RuntimeError("the gradient gate did not PASS")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 22: the gate PASSED in {time.perf_counter() - t0:.1f} s")


BENCH_TIMEOUT_S = 300
# The fields of the bench's last line, by run: the card cells at the
# defaults; at --quick --full the same without the inverse step and the
# denoised frame, and with the plain wavefront's two legs.
BENCH_CELL_FIELDS = ("value", "pallas_fwd_ms", "sharded_1dev_fwd_mrays",
                     "pallas_fwd_bwd_mrays", "ad_fwd_bwd_mrays", "vjp_fwd_bwd_mrays",
                     "sharded_1dev_fwd_bwd_mrays", "counted_flops_per_segment",
                     "achieved_tflops", "peak_fma_tflops", "mfu", "vpu_issue_util")
BENCH_RUNS = (
    ((), BENCH_CELL_FIELDS + ("inverse_step_ms", "denoised_frame_ms", "denoised_frame_fps")),
    (("--quick", "--full"), BENCH_CELL_FIELDS + ("jnp_fwd_mrays", "fwd_bwd_mrays")),
)
BENCH_TIMED = ("pallas_fwd_ms", "sharded_1dev_fwd_mrays", "pallas_fwd_bwd_mrays",
               "ad_fwd_bwd_mrays", "vjp_fwd_bwd_mrays", "sharded_1dev_fwd_bwd_mrays",
               "inverse_step_ms", "denoised_frame_ms")


def bench_phase_23(k1_ms, smi):
    """Run ``python -m pathtrace_tpu_torch.bench`` twice in fresh processes
    and hold each last line to its contract; ``k1_ms``: phase 5's K1 time
    at 512x512x32."""
    phase(23, "the port's bench in a fresh process: python -m pathtrace_tpu_torch.bench at "
              "its defaults (512x512x32), then --quick --full (128x128x4, the plain legs too)")
    root = os.path.dirname(os.path.abspath(__file__))
    for argv, fields in BENCH_RUNS:
        label = " ".join(argv) or "(defaults)"
        ts = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch.bench", *argv],
                              cwd=root, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        lines = proc.stdout.strip().splitlines()
        print(f"  bench {label}: exit {proc.returncode} after {time.perf_counter() - ts:.1f} s, "
              f"{len(lines)} lines")
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the bench {label} exited {proc.returncode}")
        records = [json.loads(line) for line in lines]  # every line is one JSON object
        last = records[-1]
        print(f"  {lines[-1]}")
        bad = [f for f in fields if not (isinstance(last.get(f), (int, float))
                                         and np.isfinite(last[f]) and last[f] > 0)]
        if bad:
            raise RuntimeError(f"the bench {label}: fields missing, not finite or not positive: "
                               f"{bad}")
        if last["backend"] != "cuda" or last.get("ad_backend") != "hand_nee_sweep":
            raise RuntimeError(f"the bench {label}: backend {last['backend']}, ad_backend "
                               f"{last.get('ad_backend')}")
        if smi.split(",")[0] not in last["device"]:
            raise RuntimeError(f"the bench {label}: device {last['device']!r}, not {smi!r}")
        if "pallas_fwd_ms" not in records[0] or "value" not in records[0]:
            raise RuntimeError(f"the bench {label}: the first line lacks the headline")
        few = [f for f in BENCH_TIMED if f in last and last["samples"].get(f, 0) < 10]
        if few:
            raise RuntimeError(f"the bench {label}: fewer than 10 samples for {few}")
        if not 0.0 < last["mfu"] <= 1.0:
            raise RuntimeError(f"the bench {label}: mfu {last['mfu']} outside (0, 1]")
        if not argv and not 0.5 * k1_ms <= last["pallas_fwd_ms"] <= 2.0 * k1_ms:
            raise RuntimeError(f"the bench: pallas_fwd_ms {last['pallas_fwd_ms']:.4f} not "
                               f"within 0.5-2x phase 5's K1 time {k1_ms:.4f} ms")
        print(f"  bench {label}: {len(fields)} fields finite and positive, mfu "
              f"{last['mfu']:.4f}, value {last['value']:.1f} Mrays/s"
              + ("" if argv else f", pallas_fwd_ms {last['pallas_fwd_ms']:.4f} against phase "
                                 f"5's {k1_ms:.4f}"))



# ---- the FMA question (phase 24) ---------------------------------------------------

FMA_PROBE_TIMEOUT_S = 600
# Keys the card's record adds to those of the TPU's (docs/fma_probe_r5.json).
FMA_PROBE_KEYS = ("device", "shape", "kernel_launches", "compiled_trip", "sm_clock_mhz",
                  "latency_cycles_per_step")


def fma_probe_phase_24(smi):
    """Run ``scripts/torch_fma_probe.py`` in a fresh process and hold its
    record: every key of the TPU's record and of ``FMA_PROBE_KEYS``, rates
    and latencies finite and above 0, backend "cuda", the card in
    ``device``, K6 and K7 launched, each compiled trip within its rtol of
    the eager one. -> (their launches {"peak", "latency"}, the cycles of a
    dependent ``fma`` step at the SM clock read right after K7)."""
    phase(24, "the FMA question in a fresh process: scripts/torch_fma_probe.py (the chains "
              "through torch.compile, then K6 and K7, then the discriminator)")
    root = os.path.dirname(os.path.abspath(__file__))
    tpu = json.load(open(os.path.join(root, "docs", "fma_probe_r5.json")))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fma_")
    try:
        out = os.path.join(tmp, "fma_probe.json")
        ts = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(root, "scripts", "torch_fma_probe.py"),
                               "--json", out, "--device", "0"], cwd=root, capture_output=True,
                              text=True, timeout=FMA_PROBE_TIMEOUT_S)
        for line in proc.stdout.splitlines():
            print(f"  {line}")
        print(f"  torch_fma_probe.py: exit {proc.returncode} after "
              f"{time.perf_counter() - ts:.1f} s")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"torch_fma_probe.py exited {proc.returncode}")
        rec = json.load(open(out))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  record: {json.dumps(rec)}")
    missing = sorted(set(tpu) - set(rec)) + [k for k in FMA_PROBE_KEYS if k not in rec]
    if missing:
        raise RuntimeError(f"the FMA record lacks {missing}")
    if rec["backend"] != "cuda" or smi.split(",")[0] not in rec["device"]:
        raise RuntimeError(f"the FMA record: backend {rec['backend']}, device {rec['device']!r}")
    numbers = {k: rec[k] for k in ("xla_mul_ops_per_s", "xla_add_ops_per_s", "xla_fma_ops_per_s",
                                   "pallas_mul_ops_per_s", "pallas_fma_flops_per_s")}
    numbers.update({f"latency {k}": v for k, v in rec["latency_ns_per_step"].items()})
    bad = [k for k, v in numbers.items()
           if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0)]
    if bad or set(rec["latency_ns_per_step"]) != set(tpu["latency_ns_per_step"]):
        raise RuntimeError(f"the FMA record: not finite, not positive or missing: {bad}")
    trips = rec["compiled_trip"]
    if set(trips) != {"mul", "add", "fma"} or not all(
            t["max_rel_err"] <= t["rtol"] for t in trips.values()):
        raise RuntimeError(f"the FMA record: a compiled trip off its eager one: {trips}")
    print("  compiled trip vs eager, max relative difference: "
          + ", ".join(f"{m} {t['max_rel_err']:.3g} (rtol {t['rtol']})"
                      for m, t in trips.items()))
    clocks = rec["sm_clock_mhz"]
    print(f"  nvidia-smi right after the latency probe: clocks.sm {clocks['clocks.sm']:.0f} MHz, "
          f"clocks.max.sm {clocks['clocks.max.sm']:.0f} MHz; fma_single_slot "
          f"{rec['fma_single_slot']}, fma/mul {rec['latency_fma_over_mul']:.3f}, two "
          f"statements/mul {rec['latency_two_stmt_over_mul']:.3f}")
    launches = rec["kernel_launches"]
    if min(launches.values()) < 1:
        raise RuntimeError(f"the FMA script did not launch K6 and K7: {launches}")
    return launches, rec["latency_cycles_per_step"]["fma"]

# -- phase 25: launches that never wait for the card ------------------------------

SYNC_STEPS = 2  # inverse steps a route under the sync check
GRAPH_SIZE, GRAPH_SPP = 256, 8  # the inverse steps' frame, for the captured launches


def _tensors(x):
    """Every tensor in an entry point's result (tuples, lists, dicts, Scene,
    Camera)."""
    import torch

    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    fields = ("radius", "position", "emission", "color") if hasattr(x, "radius") else \
        ("position", "yaw", "pitch") if hasattr(x, "yaw") else ()
    return [getattr(x, k) for k in fields]


def kernel_launch_counts(tk, gk, nk, ak) -> dict:
    """Every kernel's launch count, by its name in the kernels line."""
    out = {"pathtrace_kernel": tk.CUDA_KERNEL.launches, "ad_grad_kernel": ak.CUDA_KERNEL.launches}
    out.update({name: gk.CUDA_KERNEL.launches[mode] for mode, name, _ in GRAD_KERNELS})
    out.update({f"nee_grad_kernel[{m}]": nk.CUDA_KERNEL.launches[m] for m in nk.MODES})
    return out


def reset_launch_counts(tk, gk, nk, ak):
    tk.CUDA_KERNEL.launches = 0
    ak.CUDA_KERNEL.launches = 0
    gk.CUDA_KERNEL.launches = {m: 0 for m in gk.MODES}
    nk.CUDA_KERNEL.launches = {m: 0 for m in nk.MODES}


def main_path_calls(dev, scene, cam, size=512, spp=32, step_size=256):
    """The entry points of the main paths, as (name, call) pairs; each call
    runs one on ``dev`` with ``scene`` and ``cam`` where they lie: the CLI's
    frame (``render_aovs`` at 4 spp, as ``cli.main`` calls it),
    ``render_aovs`` and the three routes of ``fused_loss_grads`` and
    ``loss_and_grads`` at size x size x spp (the bench's frame),
    ``nee_loss_and_grads`` and ``ad_loss_and_grads`` (glossy) there too;
    ``render_color_sums`` (NEE, 16 spp), ``cross_grads`` and SYNC_STEPS steps
    of each inverse ``step_fn`` at the inverse steps' size (diffuse and
    glossy 8 spp, NEE 16). Targets lie on the card and the inverse steps
    are made here: the calls are what a step or a loss costs."""
    import torch

    from pathtrace_tpu_torch import RenderConfig, inverse
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.render import render_aovs

    gen = torch.Generator(device=dev).manual_seed(25)
    t_frame = torch.rand((size, size, 3), generator=gen, device=dev)
    t_step = torch.rand((step_size, step_size, 3), generator=gen, device=dev)
    routes = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"}}
    frame = {r: RenderConfig(width=size, height=size, spp=spp, **x) for r, x in routes.items()}
    step = {r: RenderConfig(width=step_size, height=step_size, spp=16 if r == "nee" else 8, **x)
            for r, x in routes.items()}
    p = functools.partial
    calls = [("CLI frame (render_aovs, 4 spp)",
              p(render_aovs, scene, cam, RenderConfig(width=size, height=size, spp=4), 1, dev)),
             ("render_aovs", p(render_aovs, scene, cam, frame["diffuse"], 0, dev)),
             ("render_color_sums [nee]", p(tk.render_color_sums, scene, cam, step["nee"], 0,
                                           device=dev))]
    for r in routes:
        calls += [(f"fused_loss_grads [{r}]",
                   p(gk.fused_loss_grads, scene, cam, frame[r], 0, t_frame, dev)),
                  (f"loss_and_grads [{r}]",
                   p(gk.loss_and_grads, scene, cam, frame[r], 0, t_frame, dev))]
    calls += [("nee_loss_and_grads", p(nk.nee_loss_and_grads, scene, cam, frame["nee"], 0,
                                       t_frame, dev)),
              ("ad_loss_and_grads [glossy]", p(ak.ad_loss_and_grads, scene, cam,
                                               frame["glossy"], 0, t_frame, dev))]
    calls += [(f"cross_grads [{r}]", p(gk.cross_grads, scene, cam, step[r], 3, t_step, dev))
              for r in routes]
    optimize = {"diffuse": ("color",), "nee": ("position", "radius"),
                "glossy": ("color", "position")}
    rates = {"diffuse": 2e-2,
             "nee": {"position": inverse.exponential_decay(0.5, 400, 0.02),
                     "radius": inverse.exponential_decay(0.1, 400, 0.02)},
             "glossy": {"color": 2e-2, "position": 0.5}}
    for r in routes:
        state, step_fn, _ = inverse.make_inverse_step(scene, cam, step[r], t_step, optimize[r],
                                                      rates[r], device=dev)

        def steps(step_fn=step_fn, held=[state]):
            loss = None
            for _ in range(SYNC_STEPS):
                held[0], loss = step_fn(held[0])
            return held[0].params, loss

        calls.append((f"inverse step_fn [{r}]", steps))
    return calls


def graph_cases(dev, tk, gk, nk, ak, sb, cb, sd):
    """One launch of each kernel and mode over the static device blocks
    ``sb``, ``cb``, ``sd`` at GRAPH_SIZE^2 x GRAPH_SPP, as (name, call)."""
    import torch

    from pathtrace_tpu_torch import RenderConfig

    n = GRAPH_SIZE
    cfg = RenderConfig(width=n, height=n, spp=GRAPH_SPP)
    nee, glossy = RenderConfig(width=n, height=n, spp=GRAPH_SPP, nee=True), \
        RenderConfig(width=n, height=n, spp=GRAPH_SPP, brdf="glossy")
    gen = torch.Generator(device=dev).manual_seed(26)
    px = torch.rand((n, n, 3), generator=gen, device=dev)
    ct = (torch.rand((n, n, 3), generator=gen, device=dev) - 0.5) * 1e-5
    ct3 = ct.permute(2, 0, 1).contiguous()
    kw = dict(local_h=n, spp=GRAPH_SPP, device=dev)
    p = functools.partial
    return [("K1 channels", p(tk.trace, sb, cb, sd, cfg, mode="channels", **kw)),
            ("K1 partials [nee]", p(tk.trace, sb, cb, sd, nee, mode="partials", **kw)),
            ("K1 color [glossy]", p(tk.trace, sb, cb, sd, glossy, mode="color", **kw)),
            ("K2 fused", p(gk.fused, sb, cb, sd, cfg, px, **kw)),
            ("K2 dump", p(gk.dump, sb, cb, sd, cfg, **kw)),
            ("K5 replay", p(gk.replay, sb, cb, sd, cfg, ct, **kw)),
            ("K3 fused", p(nk.fused, sb, cb, sd, nee, px, **kw)),
            ("K3 replay", p(nk.replay, sb, cb, sd, nee, ct, **kw)),
            ("K4 [glossy, colour]", p(ak.replay, sb, cb, sd, glossy, ct3, **kw))]


def launch_phase_25(dev, tk, gk, nk, ak):
    """(a) Every main-path entry point (``main_path_calls``) with scene and
    camera on the host and on the card runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any call
    that waits for the card; every output must be finite. (b) One launch of
    each kernel and mode (``graph_cases``) is captured in a CUDA graph over
    static device blocks; a changed scene (every albedo, sphere 6's radius)
    and the next frame's seed are copied into those blocks, and the replay
    must equal an eager launch on the new blocks to the bit (and differ from
    the old blocks' output). -> launches of (a), by kernel name."""
    import torch

    from pathtrace_tpu_torch import Camera, cornell_box

    phase(25, "launches that never wait for the card: (a) the main paths' entry points under "
              "torch.cuda.set_sync_debug_mode('error'); (b) each kernel captured in a CUDA graph "
              "and replayed on new device blocks")
    launches = {}
    places = {"host": (cornell_box(), Camera.create()),
              "card": (cornell_box(device=dev), Camera.create(device=dev))}
    for where, (scene, cam) in places.items():
        calls = main_path_calls(dev, scene, cam)
        torch.cuda.synchronize()
        reset_launch_counts(tk, gk, nk, ak)
        outs = {}
        ts = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for name, call in calls:
                try:
                    outs[name] = call()
                except RuntimeError as e:
                    raise RuntimeError(f"(a) {name} with scene and camera on the {where} waited "
                                       f"for the card: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_s = time.perf_counter() - ts
        counts = kernel_launch_counts(tk, gk, nk, ak)
        torch.cuda.synchronize()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for name, out in outs.items():
            ts_ = _tensors(out)
            if not ts_ or not all(bool(torch.isfinite(t).all()) for t in ts_):
                raise RuntimeError(f"(a) {name} ({where}): no output or a non-finite one")
        print(f"(a) scene and camera on the {where}: {len(calls)} entry points, none waited "
              f"for the card; enqueued in {host_s:.3f} s; every output finite; launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        print("    " + "; ".join(name for name, _ in calls))

    graph_replay_checks(dev, tk, gk, nk, ak)
    print(f"(c) launches on the main paths of (a): {json.dumps(launches)}")
    return launches


def graph_replay_checks(dev, tk, gk, nk, ak):
    """Phase 25 (b): each of ``graph_cases`` captured in a CUDA graph over
    static device blocks, replayed on a changed scene and the next frame's
    seed copied into them, must equal an eager launch on the new blocks to
    the bit and differ from the old blocks' output."""
    import torch

    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box

    scene, cam = cornell_box(), Camera.create()
    cfg = RenderConfig(width=GRAPH_SIZE, height=GRAPH_SIZE, spp=GRAPH_SPP)
    old_sb = scene.packed().to(dev)
    color = scene.color * 0.9
    radius = scene.radius.clone()
    radius[6] = radius[6] * 0.8
    new_sb = scene.replace(color=color, radius=radius).packed().to(dev)
    old_sd = tk.seed_array(tk.make_seed_block(cfg, 4), dev)
    new_sd = tk.seed_array(tk.make_seed_block(cfg, 5), dev)
    sb, sd = old_sb.clone(), old_sd.clone()
    cb = tk.camera_block(cam, cfg).to(dev)
    for name, fn in graph_cases(dev, tk, gk, nk, ak, sb, cb, sd):
        sb.copy_(old_sb)
        sd.copy_(old_sd)
        old = [t.clone() for t in _tensors(fn())]  # also loads the library before capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = _tensors(fn())
        sb.copy_(new_sb)
        sd.copy_(new_sd)
        graph.replay()
        replayed = [t.clone() for t in captured]
        eager = _tensors(fn())
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(replayed, eager))
        moved = any(not torch.equal(a, b) for a, b in zip(replayed, old))
        print(f"(b) {name:22s} replay on the new blocks = eager launch to the bit: {same}; "
              f"differs from the old blocks' output: {moved}")
        if not same or not moved or len(replayed) != len(eager):
            raise RuntimeError(f"(b) {name}: the captured launch did not read its blocks when "
                               f"replayed")
        del graph


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.io.exr import load_aovs_exr
    from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
    from pathtrace_tpu_torch.ops import build
    from pathtrace_tpu_torch.ops import grad_kernel as gk
    from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
    from pathtrace_tpu_torch.ops import trace_kernel as tk
    from pathtrace_tpu_torch.render import pack_channels
    from pathtrace_tpu_torch.utils import roofline as rf
    from pathtrace_tpu_torch.utils.timing import mrays_per_sec, time_fn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "environment")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    nvcc = run([build.find_nvcc(), "--version"]).splitlines()[-1]
    print(f"nvcc: {nvcc}")
    try:
        import triton

        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")

    phase(2, "build")
    sources = (tk.SOURCE, gk.SOURCE, nk.SOURCE, ak.SOURCE, rf.SOURCE)
    for src in sources:
        for old in build.BUILD_DIR.glob(f"lib{src.stem}-*.so"):
            old.unlink()
    t0 = time.perf_counter()
    libs = build.build_all(sources)
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(lib.name for lib in libs.values())} in {build_s:.1f} s, "
          f"in parallel (flags: {' '.join(build.NVCC_FLAGS)})")

    phase(3, "kernel vs plain on the card (128x64, 4 spp, row offset 16, sample offset 5)")
    # Scene and camera blocks on the host, as the render entry points build them.
    scene, cam = cornell_box(), Camera.create()
    sb = scene.packed()
    worst_err = 0.0
    for case, extra in CASES.items():
        cfg = RenderConfig(width=128, height=96, spp=4, **extra)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg, 0, 5, 16)
        for mode in MODES:
            kw = dict(local_h=64, spp=4, mode=mode, device=dev)
            before = tk.CUDA_KERNEL.launches
            got = tk.trace(sb, cb, seed, cfg, **kw)
            torch.cuda.synchronize()
            if tk.CUDA_KERNEL.launches != before + 1:
                raise RuntimeError("the launch counter did not move")
            ref = tk.trace_plain(sb, cb, seed, cfg, **kw)
            print(f"{case} {mode} ({tk.MODES[mode]} channels):")
            worst_err = max(worst_err, compare(f"{case}/{mode}", got, ref, mode, 4))

    phase(4, "main path: CLI single frame 512x512, 4 spp on cuda:0")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        prefix = os.path.join(out_dir, "frame")
        tk.CUDA_KERNEL.launches = 0
        rc = cli.main(["--size", "512", "-s", "4", "--device", "0", "-o", prefix])
        launches = tk.CUDA_KERNEL.launches
        if rc != 0:
            raise RuntimeError(f"CLI exited {rc}")
        print(f"kernel launches on the main path: {launches}")
        if launches < 1:
            raise RuntimeError("the main path did not launch the kernel")
        aovs = load_aovs_exr(prefix + ".exr")
        n_ch = sum(v.shape[-1] if v.ndim == 3 else 1 for v in aovs.values())
        if n_ch != 14 or not all(np.isfinite(v).all() for v in aovs.values()):
            raise RuntimeError(f"EXR holds {n_ch} channels or non-finite values")
        bmps = [f for f in os.listdir(out_dir) if f.endswith(".bmp")]
        if len(bmps) != 8:
            raise RuntimeError(f"expected 8 bitmaps, found {sorted(bmps)}")
        print(f"EXR: 14 finite channels, 8 bitmaps; mean colour "
              f"{aovs['color'].mean():.4f}")
        cfg = RenderConfig(width=512, height=512, spp=4)
        ref = tk.trace_plain(sb, tk.camera_block(cam, cfg), tk.make_seed_block(cfg, 1), cfg,
                             local_h=512, spp=4, mode="channels", device=dev)
        got = pack_channels({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in aovs.items()})
        print("CLI frame (EXR) vs plain version:")
        worst_err = max(worst_err, compare("cli/channels", got, ref, "channels", 4))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    phase(5, f"timing (median of {TIMING_ITERS} CUDA-event-timed runs after warm-up)")
    times = {}
    for spp in (4, 32):
        cfg = RenderConfig(width=512, height=512, spp=spp)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg)
        for name, fn in (("plain", tk.trace_plain), ("kernel", tk.trace),
                         ("kernel", tk.trace), ("plain", tk.trace_plain)):
            # The plain version at 32 spp (~1 s a call) is printed only.
            warmup, iters = (1, PLAIN_32_ITERS) if name == "plain" and spp == 32 else \
                (2, TIMING_ITERS)
            # time_fn's device= is the timing device; the trace device is bound here.
            ms, _ = time_fn(functools.partial(fn, device=dev), sb, cb, seed, cfg, local_h=512,
                            spp=spp, mode="channels", warmup=warmup, iters=iters, device=dev)
            times.setdefault((name, spp), []).extend(ms)
        for name in ("kernel", "plain"):
            med = statistics.median(times[name, spp])
            print(f"{name:6s} 512x512x{spp} spp x5: {med:.4f} ms/frame, "
                  f"{mrays_per_sec(512, 512, spp, 5, med / 1e3):.1f} Mrays/s "
                  f"(runs {min(times[name, spp]):.4f}..{max(times[name, spp]):.4f} ms)")

    # The colour passes of the NEE and glossy inverse steps (two launches a
    # step): CUDA events, the profiler, and the bound.
    for key, extra, spp in (("color_nee", {"nee": True}, 16),
                            ("color_glossy", {"brdf": "glossy"}, 8)):
        cfg = RenderConfig(width=256, height=256, spp=spp, **extra)
        cb = tk.camera_block(cam, cfg)
        seed = tk.make_seed_block(cfg)
        fn = functools.partial(tk.trace, sb, cb, seed, cfg, local_h=256, spp=spp, mode="color",
                               device=dev)
        ms, _ = time_fn(fn, warmup=2, iters=2 * TIMING_ITERS, device=dev)
        prof, _ = kernel_profiler_ms(fn, 2 * TIMING_ITERS, "pathtrace_kernel")
        bound = rf.bound_ms(rf.count_segments(scene, cam, cfg, 0, dev), rf.OPS_PER_SEGMENT[key],
                            PUBLISHED_F32_FLOPS)
        print(f"kernel 256x256x{spp} spp x5 colour sums ({key}): events "
              f"{statistics.median(ms):.4f} ms (runs {min(ms):.4f}..{max(ms):.4f}), profiler "
              f"{prof:.4f} ms; bound {bound:.4f} ms ({rf.OPS_PER_SEGMENT[key]} operations a "
              f"segment at {PUBLISHED_F32_FLOPS / 1e12:.0f} TFLOP/s), share of bound "
              f"{bound / prof:.3f} by the profiler")

    grad_err = grad_phase_6(dev, scene, cam, gk, tk)
    grad_launches = grad_phase_7(dev, scene, cam, gk, tk)
    grad_times, grad_err_8 = grad_phase_8(dev, scene, cam, gk, tk)

    nee_err = nee_phase_9(dev, scene, cam, nk, tk)
    nee_launches, _ = nee_phase_10(dev, scene, cam, gk, nk, tk)
    peaks, _, probes = probe_phase_11(dev, rf)
    nee_times, nee_err_12 = nee_phase_12(dev, scene, cam, gk, nk, tk)
    ad_err_13 = ad_phase_13(dev, scene, cam, ak, nk, tk)
    ad_launches, ad_err_14 = ad_phase_14(dev, scene, cam, gk, nk, ak, tk)
    ad_times, ad_err_15 = ad_phase_15(dev, scene, cam, ak, nk, tk)
    sweep_times, ad_err_16, nee_err_16 = sweep_phase_16(dev, scene, cam, ak, nk, tk, nee_times,
                                                        ad_times)
    digest_phase_17(dev, tk, gk, nvcc)
    denoise_phase_18(dev, tk, smi)
    train_phase_19(dev, tk, smi)
    grid_launches, grid_errs = grid_phase_20(dev, tk, smi)
    dp_launches = dp_phase_21(dev, tk, smi)
    gate_phase_22()
    bench_phase_23(statistics.median(times["kernel", 32]), smi)
    fma_launches, fma_cycles = fma_probe_phase_24(smi)
    sync_launches = launch_phase_25(dev, tk, gk, nk, ak)
    _PHASE_STARTS["kernels line"] = time.perf_counter()

    # One line a kernel: its time at its main shape beside its bounds.
    def frame_segments(width, spp, **extra):
        return rf.count_segments(scene, cam, RenderConfig(width=width, height=width, spp=spp,
                                                          **extra), 0, dev)

    seg = {"512x4": frame_segments(512, 4), "512x32": frame_segments(512, 32),
           "256x8": frame_segments(256, 8), "512x32 nee": frame_segments(512, 32, nee=True),
           "512x32 glossy": frame_segments(512, 32, brdf="glossy"),
           "512x32 nee glossy": frame_segments(512, 32, nee=True, brdf="glossy")}
    for name, n_seg in seg.items():
        print(f"traced segments, {name}: {n_seg}")
    ops = rf.OPS_PER_SEGMENT
    px512, px256 = 512 * 512, 256 * 256
    # (name, source, replaces, launches, max err, ms, plain ms, segments,
    #  operations a segment, bytes in + out)
    rows = [
        ("pathtrace_kernel", "trace_kernel.cu", "pathtrace_tpu/ops/pallas_trace.py:361",
         launches, worst_err, statistics.median(times["kernel", 4]),
         statistics.median(times["plain", 4]), seg["512x4"], ops["forward_diffuse"],
         px512 * 14 * 4),
    ]
    grad_bytes = {"fused": px512 * 6 * 4, "dump": px256 * (3 + 54) * 4, "replay": px512 * 3 * 4}
    for mode, name, replaces in GRAD_KERNELS:
        rows.append((name, "grad_kernel.cu", replaces, grad_launches[mode],
                     max(grad_err[mode], grad_err_8[mode]), grad_times[mode, "kernel"],
                     grad_times[mode, "plain"], seg["256x8" if mode == "dump" else "512x32"],
                     ops["grad_replay" if mode == "replay" else "grad_fused"], grad_bytes[mode]))
    rows += [
        ("nee_grad_kernel[fused]", "nee_grad_kernel.cu",
         "pathtrace_tpu/ops/pallas_nee_grad.py:98", nee_launches["fused"],
         max(nee_err["fused"], nee_err_12["fused"]), nee_times["fused", "kernel"],
         nee_times["fused", "plain"], seg["512x32 nee"], ops["nee_grad_fused"],
         px512 * 6 * 4),
        ("nee_grad_kernel[replay]", "nee_grad_kernel.cu",
         "pathtrace_tpu/ops/pallas_nee_grad.py:98", nee_launches["replay"],
         max(nee_err["replay"], nee_err_12["replay"], nee_err_16),
         nee_times["replay", "kernel"], nee_times["replay", "plain"], seg["512x32 nee"],
         ops["ad_nee_color"], px512 * 3 * 4),
        # the instance of K4's main path: glossy against a colour-only cotangent
        ("ad_grad_kernel", "ad_grad_kernel.cu", "pathtrace_tpu/ops/pallas_ad.py:64",
         ad_launches, max(ad_err_13, ad_err_14, ad_err_15, ad_err_16),
         sweep_times["glossy", 512, "kernel"], sweep_times["glossy", 512, "plain"],
         seg["512x32 glossy"], ops["ad_glossy_color"], px512 * 3 * 4),
    ]
    kernels = []
    for (name, source, replaces, n_launch, max_err, ms, plain_ms, n_seg, ops_seg,
         n_bytes) in rows:
        ops_ms = rf.bound_ms(n_seg, ops_seg, PUBLISHED_F32_FLOPS)
        bytes_ms = 1e3 * n_bytes / PUBLISHED_BYTES_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": f"pathtrace_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n_launch, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
            "bound_ms_unfused_measured": rf.bound_ms(n_seg, ops_seg, peaks["peak_mul_flops"]),
        })
    for probe, replaces in (("peak", "pathtrace_tpu/utils/roofline.py:386"),
                            ("latency", "scripts/fma_probe.py:115")):
        r = probes[probe]
        entry = {
            "name": f"probe_kernel[{probe}]", "route": "cuda",
            "source": "pathtrace_tpu_torch/csrc/probe_kernel.cu", "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(r["ops_ms"], r["bytes_ms"]),
            "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
            "library_ms": None, "bound_ms_unfused_measured": None,
        }
        if probe == "latency":
            # A dependent chain: bound by its operations' latency, not their
            # rate. "bound_by" keeps the line's two words (bytes, operations);
            # "bound_model" says which time of the operations bounds it.
            entry.update(bound_ms=r["latency_ms"], bound_model="latency",
                         bound_ms_throughput=max(r["ops_ms"], r["bytes_ms"]),
                         sm_clock_mhz=r["sm_mhz"], dependent_steps=r["steps"],
                         fma_dependent_cycles=FMA_DEPENDENT_CYCLES,
                         fma_dependent_cycles_measured=fma_cycles)
        kernels.append(entry)
    # The ranks' launches of phase 20 add to the main paths' of the kernels
    # that the grid runs, phase 21's dataset to K1's, and phase 24's to the
    # probes'.
    grid_launches["pathtrace_kernel"] += dp_launches
    for name, n in sync_launches.items():
        grid_launches[name] = grid_launches.get(name, 0) + n
    for probe, n in fma_launches.items():
        grid_launches[f"probe_kernel[{probe}]"] = n
    for k in kernels:
        k["launches"] += grid_launches.get(k["name"], 0)
        k["max_abs_err"] = max(k["max_abs_err"], grid_errs.get(k["name"], 0.0))
    print(f"card: {smi}; bound = segments x operations a segment / the published "
          f"{PUBLISHED_F32_FLOPS / 1e12:.0f} TFLOP/s (measured here: FMA "
          f"{peaks['peak_fma_flops'] / 1e12:.3f} TFLOP/s); unfused = the same over the measured "
          f"multiply-only rate {peaks['peak_mul_flops'] / 1e12:.3f} T/s")
    for k in kernels:
        if not k["bound_ms"] <= k["ms"]:
            raise RuntimeError(f"{k['name']}: a share of bound above 1")
        unfused = k["bound_ms_unfused_measured"]
        print(f"  {k['name']:26s} {k['ms']:10.4f} ms  launches {k['launches']:4d}  bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}  share of bound "
              f"{k['bound_ms'] / k['ms']:.3f}"
              + ("" if unfused is None else f"  (unfused {unfused:.4f} ms, share "
                                            f"{unfused / k['ms']:.3f})"))
    # K4's other instances beside their bounds (the kernels line carries
    # glossy against a colour-only cotangent, the instance of the main path),
    # and the kernels at the inverse steps' sizes.
    seg["256x16 nee"] = frame_segments(256, 16, nee=True)
    seg["256x8 glossy"] = frame_segments(256, 8, brdf="glossy")
    seg512 = {"diffuse": seg["512x32"], "nee_diffuse": seg["512x32 nee"],
              "glossy": seg["512x32 glossy"], "nee_glossy": seg["512x32 nee glossy"]}
    key = {"diffuse": "ad_diffuse", "nee_diffuse": "ad_nee", "glossy": "ad_glossy",
           "nee_glossy": "ad_nee_glossy"}
    others = [(f"{name}, colour + AOV cotangent 512x512x32", ad_times[name, 512, "kernel"],
               ad_times[name, 512, "plain"], seg512[name], ops[key[name]])
              for name in ("glossy", "nee_glossy", "nee_diffuse")]
    others += [(f"{name}, colour-only cotangent 512x512x32", sweep_times[name, 512, "kernel"],
                sweep_times[name, 512, "plain"], seg512[name], ops[key[name] + "_color"])
               for name in ("diffuse", "nee_diffuse", "nee_glossy")]
    others.append(("glossy, colour-only cotangent 256x256x8", sweep_times["glossy", 256, "kernel"],
                   sweep_times["glossy", 256, "plain"], seg["256x8 glossy"],
                   ops["ad_glossy_color"]))
    for label, ms, plain_ms, n_seg, ops_seg in others:
        b = rf.bound_ms(n_seg, ops_seg, PUBLISHED_F32_FLOPS)
        print(f"  ad_grad_kernel, {label:44s} {ms:8.4f} ms  bound {b:.4f} ms by operations  "
              f"share of bound {b / ms:.3f}"
              + ("" if plain_ms is None else f"  (plain {plain_ms:.1f} ms)"))
        if not b <= ms:
            raise RuntimeError(f"{label}: a share of bound above 1")
    ms = sweep_times["nee_replay", 256, "kernel"]
    b = rf.bound_ms(seg["256x16 nee"], ops["ad_nee_color"], PUBLISHED_F32_FLOPS)
    print(f"  nee_grad_kernel[replay] 256x256x16 {ms:8.4f} ms  bound {b:.4f} ms by operations  "
          f"share of bound {b / ms:.3f}  (plain "
          f"{sweep_times['nee_replay', 256, 'plain']:.1f} ms)")
    b = rf.bound_ms(seg["512x32 nee"], ops["nee_grad_two_pass"], PUBLISHED_F32_FLOPS)
    print(f"  nee_grad_kernel[fused] against the count of its own two loops "
          f"({ops['nee_grad_two_pass']} a segment; its bound above is the one-pass count, the "
          f"smaller): bound {b:.4f} ms, share {b / nee_times['fused', 'kernel']:.3f}")
    b = rf.bound_ms(seg["512x32 nee"], ops["ad_replay_nee_jaxpr"], PUBLISHED_F32_FLOPS)
    print(f"  ad_grad_kernel, nee_diffuse against the count of the TPU kernel's generated "
          f"replay ({ops['ad_replay_nee_jaxpr']} a segment): bound {b:.4f} ms, share "
          f"{b / ad_times['nee_diffuse', 512, 'kernel']:.3f}")
    print(f"seconds a phase: {json.dumps(phase_seconds())}; the whole script "
          f"{time.perf_counter() - _T0:.1f} s; torch.profiler sessions retried "
          f"{len(PROFILER_MISSES)} {PROFILER_MISSES}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        import pathtrace_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
