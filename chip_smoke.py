#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels flash_attention_decode   # one kernel
    python3 chip_smoke.py --training          # the training phases only
    python3 chip_smoke.py --launch            # the launch and examples

1. Prints the card's name and power limit, then builds the seven CUDA
   sources from ``src/repro_torch/kernels/csrc`` (seven kernels and the
   launch fixture) and prints the build time.
1b. Analysis phase (``analysis_phase``; ``--analysis`` runs it alone):
   the card's launch limits (``cudaDeviceGetAttribute``) must equal the
   constants of ``repro_torch.analysis.launch_contracts``; the launch
   fixture, the port of the reference's no-op ``_capture_2d`` kernel:
   its legal launch returns 0 and leaves a sentinel-filled output as its
   plain version does, and a launch one past each limit (232,449 bytes
   of shared memory, 1025 threads, grid y 65,536) is refused by the
   runtime, each error printed; every record of the launch sweep held
   to the C host code's own grid, threads and dynamic shared memory (each
   C entry's dry run), to the static shared memory the card reports and
   to the contracts at it, with each kernel function's registers and
   occupancy printed; then the whole registry of static checks runs
   with its trace targets on the card, whose launch counters must equal
   the kernel calls.
2. Kernel phase: each kernel at the shapes its path gives it (DeiT-Base
   batch 16, Llama-3-8B decode and 1024-token scoring) and at ragged
   shapes, against its plain PyTorch version on the same card inputs,
   timed as a median of CUDA events after warmup beside the plain version
   and, where one PyTorch call computes the same function, that call, and
   as device time from the kernel events of a ``torch.profiler`` trace;
   one JSON line per kernel.  The matmul and GELU kernels are timed at
   every Llama-3-8B decode and score shape (``TIMED_CASES``); the matmul
   kernels are also held at M 1, 16, 17 and 33, at subnormal block scales
   and at mantissas +-127; the row kernels on every route their geometry
   functions pick (softmax: registers at 1-32 elements a lane, float4 or
   scalar, masked causal rows, both sides of the register limit, rows of
   262144 on the long route; GELU: float4 at act blocks 4, 8 and 16,
   scalar at 1, 2, 12 and on unaligned rows; the LN stage of
   ``mxint_layernorm`` and ``mxint_ln_matmul``: bf16 rows as the LM hands
   them, four-element pieces at act blocks 4, 8 and 16, a block a thread
   at 1 and 12 and on unaligned rows, the global stage of rows too long
   for shared memory, subnormal scales, saturated shifts, 12-bit
   mantissas, no beta).  The LN kernels' timed cases include the Llama
   final RMSNorm and ``mxint_matmul`` at the fused kernel's shapes; one
   bf16 ``mxint_ln_linear_op`` decode call must run 2 device ops.  The
   row kernels (softmax, GELU, LN, both flash kernels) are also held at
   MXInt6 and MXInt12; the shapes Qwen3-14B and Phi-4-mini add (per-head
   q/k RMSNorm rows of 128, decode and flash at G 5 and 3) are timed.
   The widened act formats (``WIDE_ACT``, ``WIDE_ROW_BLOCKS``): both
   matmul kernels at act blocks 4, 8, 32, 64 and 256 and at 10-, 12- and
   16-bit act mantissas (at blocks 16 and 32), at DeiT-Base's FFN shapes
   (timed) and a Llama decode shape; softmax, GELU and LN at act blocks
   32, 64 and 128 at the DeiT shapes (timed).  ``mxint_matmul`` computes
   at ``act_mant_bits=10`` and act block 12 on its GEMM core and at 17
   and 24 bits on its generic route, and must raise before it launches at
   25 bits; the core's C entry must refuse 17 bits (its act tile holds
   int16 at most) and int32 planes; a kernel-mode linear on 10-bit
   weights (int16 planes) takes the GEMM core.  The GEMM core's segment
   walk (``SEGMENT_MM``, ``SEGMENT_LNMM``, ``SEGMENT_FORMER``): W12 x A8
   at act block 12 (not nested) and 16, W12 x A12 at block 16 (four mmas
   a step), W8 at act block 24 on 96-blocks, LN2 -> ``wi`` with the 13-bit
   LUT, at DeiT-Base's FFN shapes (timed) and at 4 rows, and the former
   generic formats it now takes; each must launch the core.  The generic
   routes (``GENERIC_LABELS``, under ``<kernel>/generic``): every format
   only they take, at the launch sweep's ``generic_cases`` shapes, 17-bit
   acts at DeiT-Base's FFN shapes, the served widened format's row
   kernels (act block 12, LN 13-bit, GELU 14-bit, softmax r 16), float
   activations at its FFN ``wo``, the flash kernel at r 10, int16 planes
   off the core (weight block 8; W12 x A12 at act block 64), each timed.
   Tolerance: bit-identical (0 mismatched elements) for every kernel and
   case except bf16 ``flash_attention``, whose q.k and P.V sums run on
   the tensor cores in no fixed order (``FLASH_TOL``): float mode every
   element within one bf16 ulp of the plain version's,
   quantized scores at least 99.9% within one ulp and the largest gap at
   most 5e-2 of the output scale.  Its float32 case takes the ordered
   kernel and is held to 0 mismatches.  ``flash_attention_decode`` is
   held to 0 mismatches in every case, bf16 and float32: the Llama ring
   at four depths and at the served depths, ragged rings, a wrapped window
   ring with a hole, G 1, 3 and 8, head dims 64 and 100, act blocks 4 and
   32.
3. DeiT phase: DeiT-Base at full width and depth (12 layers, d 768, 1000
   classes, random weights from a seed, packed MXInt6 planes) serves 5
   requests of 1-16 images through ``ViTServingEngine(batch=16)`` and
   ``ClassifyScheduler``; every kernel's launch count must equal
   (3 + 8 * 12) forwards' worth per batch, kernel by kernel.  Telemetry,
   the registry reset at the phase's start: submitted == completed +
   in_flight after every scheduler step, each step's
   ``scheduler/kernel_launches`` sample equal to the kernels' own counts
   of that step (3 + 8 * 12), the ``kernel/launches/*`` counters equal to
   theirs, and the ``scheduler/classify_step`` span's mean within 5% or
   0.5 ms of CUDA events around the same steps' forwards (the span is
   device-true); the snapshot's JSON and Prometheus sizes are printed.
   One 4-image batch is compared with the same model on the CPU through the plain
   versions: argmax equal and logits within 1e-3 of their scale.  One
   forward is also split by kernel with CUDA events around each call.
   One batch, one decode step (phase 4) and one score forward (phase 5)
   are traced with ``torch.profiler``: the device's busy time (kernels,
   copies, fills) and the idle share of the events' time.
4. LM serve phase: Llama-3-8B at full width and depth (32 layers, random
   weights from a seed, packed MXInt8 planes) serves 8 requests of 37-1000
   prompt tokens and 24 new tokens each through ``ServingEngine`` and
   ``BatchScheduler(batch_size=4)``, ``max_len`` 2048; every slot prefill
   must launch 257 kernels and every decode step 289, kernel by kernel,
   with the DeiT phase's telemetry checks (each call's
   ``scheduler/kernel_launches`` sample equal to its counts).  The
   unembedding of a step is timed.
5. LM score phase: one 1024-token ``DecoderLM.loss`` forward at full size;
   32 ``flash_attention`` launches, no whole-row softmax.
6. LM card against CPU: the same architecture at full width, 1 layer, in
   float32, serves 2 requests (prompts 100 and 250, ``max_len`` 300, 4 new
   tokens) and scores 640 tokens (the flash path in kernel mode) on the
   card and on the CPU (the kernels' plain versions in kernel mode): in
   kernel mode and in "off" (float weights), "sim" and "packed" (MXInt8
   planes; both with the MXInt non-linears), which run the float decode
   over the ring, the direct attention and the query-blocked attention.
   Identical tokens, argmax equal at every position, logits within 1e-3 of
   their scale; the non-kernel modes launch no kernel.
7. Backends phase: DeiT-Base at full width and depth (the DeiT phase's
   weights) serves the same 5 requests in "off" and "fake" (float
   weights), "sim" and "packed" (MXInt6 planes) with the MXInt
   non-linears, and "mixed": kernel mode on packed planes with the FFNs
   overridden to "sim" (``QuantOverride``).  No kernel launches in the four
   non-kernel modes; the mixed one launches 3 + 5 * 12 kernels a forward,
   kernel by kernel.  Each is timed (ms per batch by CUDA events, device
   busy time and idle share from a trace), held card against CPU at 2
   layers and 4 images (argmax equal, logits within 1e-3 of their scale,
   the count of differing elements printed), and sim is held against the
   all-kernel model at full depth within ``SIM_KERNEL_TOL``.
8. Probes: the reference's four kernel probe labels
   (``repro_torch.telemetry.probes``), each timed by a device-true span;
   their mean ms are printed beside the card's name and power limit.
9. Qwen3-14B (40 layers, d 5120, 40 heads over 8, qk-norm, vocab 151936)
   and Phi-4-mini (32 layers, d 3072, 24 heads over 8, tied embeddings,
   vocab 200064), each at full width and depth, random
   packed MXInt8 weights: 4 requests of 37-700 prompt tokens and 16 new
   tokens through the LM serve phase's checks, with the launch counts
   ``lm_launches`` derives (Qwen3-14B 401 a slot prefill and 441 a decode
   step, Phi-4-mini 257 and 289); then a 1-layer full-width card-against-
   CPU check in kernel, "sim" and "packed" mode, phase 6's tolerance.
10. DSE phase: kernel-mode DeiT-Base at full width and depth, random
   weights from seed 0, calibrated on 32 images of
   ``SyntheticImageData(n_classes=1000, image_size=224, seed=0)``
   (``repro_torch.dse``): (a) the reference CLI's per-group space
   (``block/*/attn`` and ``block/*/ffn`` at weight bits 3, 4, 6, 8: 16
   points, exhaustive), (b) act bits 6, 8, 12 x act blocks 16, 32 on
   every scope (6 points), (c) the greedy driver at the 1% budget on (a).
   Per candidate: accuracy (argmax agreement with the float model),
   fidelity, weight bits, the predicted device-memory bytes of one
   DeiT-Base forward's kernels at batch 16 (the Hopper cost table, each
   row times its calls, at each call site's act format), ms per
   evaluation (the device-true
   ``span/dse/eval``) and launches per forward (3 + 8 x 12, each checked);
   the Pareto fronts.  Then space (b) at 2 layers on the card and on the
   CPU (16 images): logits bit for bit, accuracy equal, fidelity within
   1e-6.  The probes phase (8) prints the four probe labels' measured
   time against the cost table's prediction (``predicted_vs_measured``).
11. Widened serve: DeiT-Base served through ``ClassifyScheduler`` with the
   FFNs at act block 32 (``QuantOverride(act_fmt=MXFormat(8, 32))``),
   with 12-bit acts everywhere, and at the widened format
   (``wide_quant``: W12 planes, act block 12, Table VI's vanilla LUTs),
   whose 74 GEMM launches a batch run on the GEMM core and whose 25 row
   kernel launches take their generic routes (one batch traced: busy ms,
   idle share, device ms by kernel and route), and with 17-bit acts, whose
   74 GEMM launches take the generic GEMM routes, the DeiT phase's
   telemetry and launch checks; ms per batch.  Then Llama-3-8B at
   full width and one layer at score act block 64 (``widened_lm_phase``):
   3 requests and a 1024-token score, every flash and decode launch on
   the generic route.  After the timed phases, DeiT-Tiny (2 layers) at
   the widened format on the card against the CPU, in the CPU pool: 0
   differing logits (``widened_cpu_phase``).
12. Mixture of experts: Mixtral-8x7B (d 4096, 32 heads over 8, 8
   experts top-2, d_ff 14336, vocab 32000, window 4096) and Granite-MoE-3B
   (d 1536, 24 heads over 8, 40 experts top-8, d_ff 512, tied vocab
   49155), each at full width and ``MOE_SERVE_LAYERS`` (8) of their 32
   layers with random packed MXInt8 weights, after every earlier model is
   freed (the free memory logged): served as in phase 9 (4 requests of
   37-700 tokens, 16 new), with 65 launches a slot prefill and 73 a
   decode step (a MoE
   layer: q, k, v fused norm -> linears, the decode attention, the
   attention's out and the router linears, the RMSNorm before the FFN,
   the gates' softmax, the experts' SiLU); one decode step split by
   kernel and "experts" (the expert stacks' dequantize and einsums),
   beside the byte bounds of the planes read once and of the dequantize;
   one 1024-token ``loss`` forward with the load-balancing loss; then a
   ``MOE_CPU_LAYERS``-layer (1) card-against-CPU check in kernel mode,
   phase 6's tolerance.
   The kernel phase holds the MoE shapes: routers at N 8 and 40, the
   gates' softmax over rows of 2 and 8, the SiLU over (E x C, d_ff)
   capacity buffers, the RMSNorm before the FFN.
13. DeepSeek-67B at full width (d 8192, 64 heads over 8, d_ff 22016,
   vocab 102400) and ``DEEPSEEK_LAYERS`` (16) of its 95 layers, served as
   in phase 9, 129 launches a slot prefill and 145 a decode step.
14. Recurrent families: RecurrentGemma-2B (26 layers: (rec, rec, attn) x
   8 and a (rec, rec) tail; d 2560, RG-LRU width 2560, local attention of
   10 heads over one KV head at head dim 256, window 2048, GeGLU 7680,
   tied vocab 256000) and xLSTM-350M (24 layers: (7 mLSTM + 1 sLSTM) x 3;
   d 1024, 4 heads, no FFN, tied vocab 50304), each at full width and
   depth with random packed MXInt8 weights: 4 requests of 64-512 prompt
   tokens (powers of two: a prompt fills its bucket, so no pad token
   enters a recurrent state) and 16 new tokens through the LM serve
   phase's checks, the launches of every call from ``lm_launches`` by
   block kind (RecurrentGemma 263 a slot prefill and 271 a decode step;
   xLSTM 202 a decode step and 171 + 6 P a P-token slot prefill, its
   sLSTM layers 2 linears a token); one decode step split by kernel
   beside the unembedding; one 512-token slot prefill split by kernel and
   by recurrent scan (``rglru_scan``, ``mlstm_scan``, ``slstm_scan``); a
   1024-token score (RecurrentGemma: ``flash_attention`` at head dim 256)
   and RecurrentGemma's 512-token one (the whole-row softmax); then one
   unit (RecurrentGemma 3 layers, xLSTM 8) card against CPU in kernel,
   "sim" and "packed" mode, phase 6's tolerance, RecurrentGemma scoring
   520 tokens (the flash kernel) and 512 (the whole-row softmax, whose
   score and P.V products run in float64, rounded once).  The kernel phase holds
   both flash kernels at head dim 256 (G 10 over one KV head, rings of 64,
   512 and 2048 slots, a wrapped ring, the 1024-token score, both dtypes)
   and kernels 1-5 at the two models' shapes (``mxint_matmul`` at N 4:
   the mLSTM gates).
15. VLM: LLaVA-NeXT-Mistral-7B at full width and depth (32 layers, d
   4096, 32 heads over 8, d_ff 14336, vocab 32000, 2880 vision positions
   of dim 1024) on random packed MXInt8 planes (the projector stays
   float and is packed at each call): 4 requests of 3072 positions (2880
   vision, 192 text) through ``ServingEngine.generate``, 16 new tokens,
   ``max_len`` 4096; 258 launches the prefill (the projector's linear and
   8 a layer; its attention is float) and 289 every decode step, kernel
   by kernel (``lm_launches``); the prefill, one decode step (by kernel,
   busy time, idle share) and the unembedding timed; a 3072-position
   score with vision embeddings (290 launches, the flash kernel in every
   layer).  Then 1 layer card against CPU, kernel mode, 448 vision
   positions: 2 requests of 512 positions (4 new tokens) and a
   576-position score (the flash kernel), phase 6's tolerance.
16. Encoder-decoder: SeamlessM4T-medium at full width and depth (12 +
   12 layers, d 1024, 16 heads, d_ff 4096, vocab 256206) on random
   packed MXInt8 planes: 4 requests of 1024 frames (the encoder's non-
   causal flash kernel) and 16 prompt tokens through ``generate``, 16
   new tokens, then 4 of 256 frames (the encoder's whole-row softmax);
   302 launches a prefill and 169 a decode step, kernel by kernel
   (``encdec_launches``: the cross-attention's whole-row softmax and the
   decode kernel in every step); the encoder, ``encode_kv``, a decode
   step (by kernel) and the unembedding timed.  Then 1 + 1 layers card
   against CPU, kernel mode, at 256 and 640 frames: 2 requests (4 new
   tokens) and a cache-less forward's logits, phase 6's tolerance.
   The kernel phase holds kernels 1-7 at the two models' new shapes
   (the projector, Seamless's linears, GELU and RMSNorm at d 1024 and
   d_ff 4096, softmax rows of 1024 and 256 keys at one query a head, the
   non-causal flash kernel at head dim 64 over 1024 frames, the flash
   kernel at 3072 positions, decode rings of 4096 slots at G 4 and of 512
   at G 1, head dim 64), SDPA timed beside each attention case.
17. Train: DeiT-Base at full width and depth (random weights from seed
   0) trained through ``TrainLoop`` on ``SyntheticImageData(n_classes=
   1000, image_size=224, batch=64, seed=0)`` in "fake" (QDQ with the
   serving formats, weights MXInt6/256, acts MXInt8/16): one step run
   twice from one state (is the backward deterministic?), one step on a
   fixed batch timed by CUDA events and traced (device busy ms, idle
   share, the products' kernels, the top kernels by time; the forward-
   backward and the AdamW update apart), then 8 steps with a checkpoint
   at step 4, and a fresh loop from a fresh state resumed from that
   checkpoint to step 8: the resumed params and moments must equal the
   straight run's bit for bit when the repeated step was deterministic.
   Per run: loss and grad norm at each step, ms per step (the
   ``train/step`` span; median and range), the span against CUDA events
   from each batch's draw to the step's return, the peak GiB allocated.
   Then 3 steps in "off", reported the same way.  Then one value-and-
   grad of DeiT-Micro in "off", "fake" and "sim" on the card and on the
   CPU: every gradient leaf within ``GRAD_CPU_TOL`` of its scale.
18. Accuracy: ``benchmarks/common.py``'s recipe on the card: the micro
   DeiT (4 layers, d 64, 100 classes) trained 700 steps at batch 64 in
   "off" on its hard 100-class task, then evaluated (8 batches of 128
   from seed 99) as float, in Table V's eight rows ("fake", with the fp8
   and per-tensor int emulations) and in "sim" and kernel mode (packed
   planes, the MXInt non-linears) at MXInt8/MXInt8 and MXInt6/MXInt8:
   accuracy and delta against float, the reference's two claims
   (printed, not gated), kernel against sim argmax agreement, kernel-mode
   launches 2 x (3 + 8 x 4) a batch.  The same trained params on the CPU
   must give the same sim and kernel-mode accuracy.  ``make_train_step``
   must refuse kernel mode and packed planes on the card.
19. LM train: Llama-3-8B at full width cut to 2 layers (float32, about
   1.49 G parameters) trained 4 steps in "off" on ``SyntheticLMData(
   vocab=128256, batch=2, seq_len=512, seed=5)``: ms per step, peak
   GiB, finite losses and grad norms.  Then the SMOKE Llama-3 trained 5
   steps from one initial state on the card and on the CPU: losses
   within ``LM_SMOKE_LOSS_TOL`` relative, the largest parameter gap
   printed.
20. Recurrent and new-family training: RecurrentGemma-2B at full width
   and 2 of its 8 units (6 layers) and xLSTM-350M at full width and
   depth, 3 steps each in "off" on ``SyntheticLMData(batch=2,
   seq_len=256, seed=5)``: ms per step, the sLSTM loops' share of it
   (CUDA events around each ``slstm_scan``, the forward's), peak GiB,
   finite losses and grad norms.  Then the SMOKE RecurrentGemma, xLSTM,
   LLaVA (vision embeddings) and Seamless (frames) each trained 5 steps
   on the card and on the CPU: losses within ``LM_SMOKE_LOSS_TOL``.
   Phases 19-20 train with each config's own ``remat`` ("block" for the
   LMs: each unit recomputed in the backward pass) and then run
   ``REMAT_COMPARE_STEPS`` steps without it: ms a step and peak GiB of
   both, the first step's loss equal.
21. tp: DeiT-Base at full width and depth (MXInt6 planes, MXInt8 acts,
   batch 16) served over ``TP_RANKS`` ranks sharing the card
   (``repro_torch.parallel.spawn``: gloo on cuda:0, the kernels built
   first): the column strategy over ``make_tp_mesh(2)`` and the data axis
   over ``make_serving_mesh(dp=2, tp=1)`` equal to the single-process
   engine bit for bit; the row strategy within ``ROW_TOL`` of the
   single process on its own planes (blocks clamped to the per-rank K)
   with argmax equal, its gap to the default planes printed; each
   forward's launches per rank, by the kernels' counters and by calls,
   equal to ``vit_launches``, and its collectives printed; a stream of 7
   requests of 1-8 images through ``ClassifyScheduler`` on the column
   engine, every request classified and every step's launches per rank
   equal to ``vit_launches``; ms a batch and peak GiB per rank beside the
   card's name and power limit (two ranks share one card: no scaling
   number).  Then ``POD_STEPS`` "off" steps of DeiT-Base, 16 images a
   pod, over a ("pod",) mesh of 2 with ``grad_compression=True``: ms a
   step, peak GiB per rank, the residuals nonzero after every step.  The
   kernel phase holds ``mxint_matmul`` at the row strategy's shard
   shapes: K 384 at block 192 and K 1536 at block 256 (DeiT-Base), K 96
   at block 96 (DeiT-Tiny), 0 mismatches.
22. Card against CPU, after every timed phase: the checks of phases 6,
   9, 12 and 14-16 run here (``card_vs_cpu_phases``), those whose CPU
   sides take longest first.  A pool of ``os.cpu_count()`` worker
   processes, ``CPU_THREADS`` torch threads each (``CpuChecks``), starts
   first; each card side runs in turn and its CPU side goes to the pool
   at once, beside phase 21's (the row strategy at 2 layers bit for bit,
   DeiT-Micro's pod steps within ``LM_SMOKE_LOSS_TOL``, on 2 gloo CPU
   ranks); each check compares when every CPU side is back.
22b. Launch (``launch_phase``; ``--launch`` runs it and 22c alone):
   the launch dry run (``repro_torch.launch.dryrun.run_cell``) of
   Llama-3-8B at full width cut to ``LAUNCH_LAYERS`` layers on the
   one-card mesh (1, 1), for an MXInt6-planes decode step at batch 4 over
   a 2048-position cache and a bf16 train step at batch 2 x 256, held
   against the same steps on the card: the predicted resident bytes equal
   the bytes that placing the parameters, state, cache and inputs
   requests (``requested_bytes``, within ``LAUNCH_ROUND`` bytes a
   tensor; the allocator's blocks above the requests printed); the
   predicted FLOPs equal
   ``FlopCounterMode``'s on the card; the predicted transient peak within
   ``LAUNCH_PEAK_TOL`` of ``max_memory_allocated`` above the arguments;
   each step's ms (CUDA events) printed beside the roofline's three terms
   and its share.  And ``python -m repro_torch.launch.dryrun --arch
   llama3_8b --shape decode_32k --mesh single``, in a subprocess started
   before the tp phase (it needs no card): both variants ``ok``.  The
   phase runs while the pool of item 22 works.
22c. Examples (``examples_phase``): the four drivers of
   ``repro_torch.examples`` on the card at their smallest flags, side by
   side in processes of their own, after phase 20 (before the pool of
   item 22 starts): ``quickstart``; ``serve_deit_mxint``
   with kernel == sim on every batch; ``serve_llm_mxint --kernel`` (its
   tokens, and the decode and matmul kernels launched);
   ``train_lm_fault_tolerant`` resumed equal to the straight run.
23. Prints one JSON line of per-kernel results, then as the last line
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.

Details also go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the bounds and their operation counts come from the Hopper cost table;
# the flash kernels' q.k and P.V products (4 * head dim operations per
# kept pair) have bf16 operands, so their least time is at the bf16
# tensor-core rate
from repro_torch.analysis.cost_model import (ROW_OPS, bound,  # noqa: E402
                                             gemm_f32_ops, int8_splits)
# every call's launches, by kernel, from the model's block kinds
from repro_torch.models.launches import (encdec_launches,  # noqa: E402
                                         lm_launches)

SEED = 0
BATCH = 16
DEVICE = "cuda"
REPLACES = {
    "mxint_matmul": "src/repro/kernels/mxint_matmul.py:109",
    "mxint_ln_matmul": "src/repro/kernels/mxint_ln_matmul.py:89",
    "mxint_softmax": "src/repro/kernels/mxint_softmax.py:65",
    "mxint_gelu": "src/repro/kernels/mxint_gelu.py:52",
    "mxint_layernorm": "src/repro/kernels/mxint_layernorm.py:118",
    "flash_attention": "src/repro/kernels/flash_attention.py:213",
    "flash_attention_decode": "src/repro/kernels/flash_attention.py:322",
}
SOURCES = {n: f"src/repro_torch/kernels/csrc/{n}.cu" for n in REPLACES}
SOURCES["flash_attention_decode"] = \
    "src/repro_torch/kernels/csrc/flash_attention.cu"
# The bf16 flash_attention runs q.k and P.V on the tensor cores, whose f32
# sums have no fixed order, so the card holds it to its plain version
# within a tolerance; every other kernel case, float32 flash_attention
# included, is held to 0 mismatches.  Float mode: every element within one
# bf16 ulp of the plain version's (only the summation order differs before
# the final rounding to bf16).  Quantized scores: at least 99.9% of the
# elements within one ulp and the largest gap at most 5e-2 of the output
# scale.  A score or p at an MXInt rounding tie may round the other way
# and move its row: a few rows, by up to 1.3e-2 of the scale on the card.
# A kernel without the P requantize is off in most rows, by no more than
# that (6.7e-3 to 1.3e-2 at the CPU test shapes), so the share catches it
# and the gap cannot (tests/test_torch_flash.py).
# The ulp of an element is taken at no less than ULP_FLOOR of the output
# scale, the ulp of an element at 2^-11 of it: below that the f32 sums'
# own rounding (about 2^-24 of the terms' magnitude, in the plain version
# as in the kernel) exceeds the element's bf16 ulp, whatever the order.
# (bf16, mxint with quantized scores) -> (share within one ulp, max gap over
# the output scale), or None for bit for bit
ULP_FLOOR = 2.0 ** -19
FLASH_TOL = {(False, False): None, (False, True): None,
             (True, False): (1.0, None), (True, True): (0.999, 5e-2)}
# cases timed beside each kernel's first one: the served ring's depths of
# the decode kernel, the shapes at which a Llama-3-8B decode step and
# score forward spend the matmul, LN and GELU kernels' time, and
# mxint_matmul at the fused kernel's shapes
TIMED_CASES = {"deit_base_b16_tp_row_attn_out", "deit_base_b16_tp_row_ffn_wo",
               "llama3_8b_decode_b4_W2048_served_mxint",
               "llama3_8b_decode_attn_wo", "llama3_8b_decode_ffn_wo",
               "llama3_8b_score_ffn_wo", "llama3_8b_decode_k4096_n1024",
               "llama3_8b_decode_k4096_n14336", "llama3_8b_score_attn_wo",
               "deit_base_b16_ffn_wi_core", "llama3_8b_decode_final_rms",
               "llama3_8b_prefill_final_rms", "deit_base_b16_final_ln",
               "llama3_8b_decode_rms_wq",
               "llama3_8b_decode_rms_wk", "llama3_8b_decode_rms_wi",
               "llama3_8b_score_rms_wq", "llama3_8b_score_rms_wi",
               "llama3_8b_decode_silu", "llama3_8b_score_silu",
               # the shapes Qwen3-14B and Phi-4-mini add: per-head q/k
               # RMSNorm rows of 128, decode and flash at G 5 and 3
               "qwen3_14b_decode_q_norm", "qwen3_14b_decode_k_norm",
               "qwen3_14b_prefill_q_norm",
               "qwen3_14b_decode_b4_W2048_served_mxint",
               "phi4_mini_decode_b4_W2048_served_mxint",
               "qwen3_14b_g5_650_causal_mxint",
               "phi4_mini_g3_650_causal_mxint",
               # the softmax's long route at block 16 (registers a block)
               "long_n1040_b16", "long_rows_2x262144_b16",
               # the MoE shapes: routers, gates, the experts' SiLU, LN2
               "mixtral_decode_router", "mixtral_prefill_router",
               "granite_decode_router", "granite_prefill_router",
               "mixtral_decode_gates_4x2", "mixtral_prefill_gates_1024x2",
               "granite_decode_gates_4x8", "granite_prefill_gates_1024x8",
               "unaligned_granite_gates_1024x8",
               "mixtral_decode_experts_silu", "mixtral_prefill_experts_silu",
               "granite_decode_experts_silu", "mixtral_decode_ln2_rms",
               "granite_decode_ln2_rms",
               # head dim 256: RecurrentGemma-2B's served decode ring and
               # its 1024-token score (SDPA timed beside both)
               "recurrentgemma_decode_b4_W2048_served_mxint",
               "recurrentgemma_decode_b4_W2048_served_mxint_f32",
               "recurrentgemma_score_1024_causal_mxint",
               "recurrentgemma_score_1024_causal_mxint_f32",
               "recurrentgemma_score_1024_causal_float",
               # kernels 1-5 at RecurrentGemma-2B's and xLSTM-350M's
               # decode and score shapes
               "recurrentgemma_decode_rglru_w_a",
               "recurrentgemma_decode_ffn_wo", "recurrentgemma_score_ffn_wo",
               "xlstm_decode_gate_w_f", "xlstm_prefill_gate_w_f",
               "xlstm_slstm_token_w_in", "xlstm_decode_slstm_r_in",
               "recurrentgemma_decode_rms_wq", "recurrentgemma_decode_rms_wk",
               "recurrentgemma_score_rms_wi",
               "recurrentgemma_score512_causal_n512_g10",
               "recurrentgemma_decode_rglru_gelu",
               "recurrentgemma_score_geglu", "recurrentgemma_decode_rms",
               "xlstm_decode_rms",
               # LLaVA-NeXT-Mistral-7B and SeamlessM4T-medium: the
               # projector, Seamless's linears, GELU and RMSNorm, its
               # whole-row cross-attention and encoder rows, its encoder's
               # non-causal flash, LLaVA's 3072-position flash and 4096-
               # slot decode ring, Seamless's decode ring (SDPA beside
               # each attention case)
               "llava_prefill_vision_proj", "seamless_decode_wq",
               "seamless_decode_ffn_wo", "seamless_encode_kv",
               "seamless_encoder_ffn_wi", "seamless_encoder_ffn_wo",
               "seamless_decode_cross_n1024", "seamless_decode_cross_n256",
               "seamless_prefill_cross_16x1024", "seamless_encoder_256",
               "seamless_decode_gelu", "seamless_encoder_gelu",
               "seamless_decode_rms", "seamless_encoder_rms",
               "seamless_encoder_1024_full_d64_mxint",
               "llava_score_3072_causal_mxint",
               "llava_decode_b4_W4096_served_mxint",
               "seamless_decode_b4_W512_g1_d64_mxint"}
# act mantissa widths of the row kernels' MXInt6 and MXInt12 cases
MANT_BITS = {"mant6": 6, "mant12": 12}
# the widened act formats of the matmul kernels' cases: (act block, act
# mantissa bits); and the row kernels' act blocks past 16
WIDE_ACT = ((4, 8), (8, 8), (32, 8), (64, 8), (256, 8), (16, 10), (16, 12),
            (16, 16), (32, 10), (32, 12), (32, 16))
WIDE_ROW_BLOCKS = (32, 64, 128)
# the widened formats are timed at the DeiT shapes
TIMED_CASES |= {f"deit_base_b16_{s}_a{b}_m{m}" for s in ("ffn_wo", "ln2_wi")
                for b, m in WIDE_ACT} | {
    f"{s}_b{b}" for s in ("deit_rows_n256", "deit_base_b16_ffn",
                          "deit_base_b16_final_ln") for b in WIDE_ROW_BLOCKS}
LM_PROMPTS = (37, 64, 120, 255, 300, 512, 700, 1000)
LM_NEW_TOKENS = 24
LM_BATCH = 4
LM_MAX_LEN = 2048
LM_SCORE_TOKENS = 1024
# layers of phase 6 (Llama-3-8B card against CPU in four modes): 1, cut
# from 2 for the smoke's time; most of the CPU's time there is the plain
# kernels and the unembedding, per call
LM_CPU_LAYERS = 1
# Qwen3-14B and Phi-4-mini (config modules), at full width and depth:
# served 4 requests of 37-700 prompt tokens, 16 new tokens each; their
# card-against-CPU check serves prompts of 37 and 100 tokens and scores
# 520 (past 512 x 512 scores: the flash path), fewer than Llama's 100, 250
# and 640, in kernel, "sim" and "packed" mode (the only checks of "sim"
# and "packed" over a tied table, Phi-4-mini's, and over per-head q/k
# RMSNorms, Qwen3-14B's), at NEW_LM_CPU_LAYERS layers: 1, cut from 2 for
# the smoke's time (at 2 layers the CPU side took 255 and 91 s).
# Every card-against-CPU check draws and packs its parameters on the card
# and copies them to the CPU (``cpu_check_params``): drawn on the CPU they
# took 20-40 s a check
NEW_LMS = ("qwen3_14b", "phi4_mini_3_8b")
NEW_LM_PROMPTS = (37, 150, 400, 700)
NEW_LM_NEW_TOKENS = 16
NEW_LM_CPU_MODES = ("kernel", "sim", "packed")
NEW_LM_CPU_PROMPTS = (37, 100)
NEW_LM_CPU_SCORE = 520
NEW_LM_CPU_LAYERS = 1
# the DSE phase: calibration images; its card-against-CPU check's depth and
# images (the CPU's plain versions take about 5 s a candidate at 16)
DSE_IMAGES = 32
DSE_CPU_LAYERS = 2
DSE_CPU_IMAGES = 16
# the mixture-of-experts decoders (config modules) at full width and
# MOE_SERVE_LAYERS of their 32 layers, served as NEW_LMS are; their
# card-against-CPU check in kernel mode at MOE_CPU_LAYERS layers (1 since
# the generic routes' cases joined the kernel phase: Mixtral's CPU side
# at 2 layers held four of the pool's cores for 187 s; at 2 one layer's
# expert outputs fed the next layer's router, and the float64 expert
# products, rounded once, give both devices the same router inputs at
# any depth).  DeepSeek-67B at full width and DEEPSEEK_LAYERS of its
# 95 layers (all 95 would hold 62.8 GiB of planes, 3.0 GiB of ring at
# batch 4 and about 11 GiB of float32 temporaries while the unembedding
# is dequantized, too close to the card's 79.2 GiB).  The depths were cut
# (DeepSeek from 64 to 32 and the MoE serves from 32 to 16 with the
# recurrent phases; DeepSeek to 16 and the MoE serves to 8 with the VLM,
# the encoder-decoder and the recurrent training) to keep the smoke under
# its command time; the layers run the same kernels at the same shapes,
# only fewer times.
MOE_LMS = ("mixtral_8x7b", "granite_moe_3b_a800m")
MOE_SERVE_LAYERS = 8
MOE_CPU_LAYERS = 1
DEEPSEEK_LAYERS = 16
# the recurrent families (config modules) at full width and depth: served
# REC_PROMPTS (powers of two: no pad token enters a recurrent state),
# REC_NEW_TOKENS each, batch LM_BATCH, max_len LM_MAX_LEN; scored
# LM_SCORE_TOKENS tokens (RecurrentGemma also REC_SOFTMAX_SCORE: the
# whole-row softmax); a REC_PREFILL_SPLIT-token slot prefill split by
# kernel and by scan; card against CPU at one unit in REC_CPU_MODES,
# serving REC_CPU_PROMPTS and scoring REC_CPU_SCORE tokens: RecurrentGemma
# 520, past 512 x 512 scores (the flash path, as the other LMs' checks
# score), and 512 (the whole-row path, whose score and P.V products are
# float64, rounded once: as float32 ``torch.matmul`` calls they summed in
# another order on each device and moved act-grid steps at 512 tokens,
# about 1% of the logit scale); xLSTM 512 (whole 256-token mLSTM chunks)
REC_LMS = ("recurrentgemma_2b", "xlstm_350m")
REC_PROMPTS = (64, 128, 256, 512)
REC_NEW_TOKENS = 16
REC_SOFTMAX_SCORE = 512
REC_PREFILL_SPLIT = 512
REC_CPU_MODES = ("kernel", "sim", "packed")
REC_CPU_PROMPTS = (64, 128)
REC_CPU_SCORE = {"recurrentgemma_2b": (520, 512), "xlstm_350m": 512}
# the recurrent scans a prefill split times, by the block kind that runs
# them
REC_SCANS = {"rglru_scan": "rec", "mlstm_scan": "mlstm",
             "slstm_scan": "slstm"}
# launches of a slot prefill and a decode step at full depth, from
# lm_launches: Llama-3-8B and Phi-4-mini 8 L + 1 and 9 L + 1 at 32
# layers; Qwen3-14B adds 2 RMSNorms a layer, 10 L + 1 and 11 L + 1 at 40;
# a MoE layer launches as many as a dense one (Mixtral-8x7B and
# Granite-MoE-3B at their 8 served layers); DeepSeek-67B at its 16;
# RecurrentGemma-2B 18 rec layers of 11 (an RMSNorm, 5 linears and the
# GELU, the FFN's 2 fused norm -> linears, GELU and out linear) and 8 attn
# layers of 8 (9 a decode step), + 1; xLSTM-350M 21 mLSTM layers of 9 (an
# RMSNorm, 8 linears) and 3 sLSTM layers of 2 + 2 P (the RMSNorm, 2
# linears a token, the out linear), + 1: at a 64-token prefill 580, a
# decode step 202.  The slot prefill's count is at a 64-token bucket.
FULL_DEPTH_LAUNCHES = {"llama3_8b": (257, 289), "phi4_mini_3_8b": (257, 289),
                       "qwen3_14b": (401, 441),
                       "mixtral_8x7b": (65, 73),
                       "granite_moe_3b_a800m": (65, 73),
                       "deepseek_67b": (129, 145),
                       "recurrentgemma_2b": (263, 271),
                       "xlstm_350m": (580, 202)}
# "sim" against the all-kernel model on the same weights and images: the
# linears' f32 sums run in another order (float64 against the kernels'
# ordered f32 steps) and the GELU clips at -128 against -127, so a later
# MXInt rounding step moves now and then.  Measured on the CPU
# (tests/test_torch_backends.py::test_sim_against_kernel_within_tolerance):
# 4-layer DeiT-Tiny 3.7e-2 of the logit scale, 8-layer 3.6e-2 with 7 of 8
# argmax equal; held to a largest gap of 0.1 of the scale and at least 3/4
# of the rows' argmax equal.
SIM_KERNEL_TOL = {"max_gap_over_scale": 0.1, "argmax_agreement": 0.75}
# the backends phase: label -> (mode, config kwargs, packed planes)
BACKENDS = {"off": ("off", {}, False), "fake": ("fake", {}, False),
            "sim": ("sim", {"quantize_nonlinear": True}, False),
            "packed": ("packed", {"quantize_nonlinear": True}, True),
            "mixed": ("kernel", {"quantize_nonlinear": True,
                                 "overrides": "block/*/ffn"}, True)}

# the training phases.  DeiT-Base at full width in "fake" (the serving
# formats) for TRAIN_STEPS steps at batch TRAIN_BATCH (26.8 GiB at peak),
# a checkpoint every TRAIN_RESUME_AT steps and a resume from the first
# one; then TRAIN_OFF_STEPS steps in "off"
TRAIN_BATCH = 64
TRAIN_STEPS = 8
TRAIN_RESUME_AT = 4
TRAIN_OFF_STEPS = 3
TRAIN_LR = 1e-4
# DeiT-Micro's gradients card against CPU, largest gap over each leaf's
# scale: the float64 products round once on both devices; the float32
# sums over the batch of the broadcast leaves' gradients run in another
# order on each; measured on the H100: 2.34e-7 ("off"), 2.31e-7 ("fake")
# and 6.7e-8 ("sim") (PERF.md)
GRAD_CPU_TOL = 5e-7
# the accuracy phase: benchmarks/common.py's recipe (BENCH_DEIT, _TASK:
# DEIT_MICRO with 100 classes on a hard 100-class task; 700 steps at batch
# 64, lr 1e-3, weight decay 0.01, "off"; eval_accuracy over 8 batches of
# 128 from seed 99), and Table V's rows (name, weight bits, act bits,
# emulate) of benchmarks/table5_quantization.py
ACC_TASK = dict(n_classes=100, image_size=32, noise=1.0, class_sep=0.25,
                outlier_channels=False)
ACC_STEPS = 700
ACC_LR = 1e-3
ACC_EVAL_BATCHES = 8
ACC_EVAL_SEED = 99
TABLE5_ROWS = (("float8_e4m3", 8, 8, "fp8"), ("int16_w16a16", 16, 16, "int"),
               ("int8_w8a8", 8, 8, "int"), ("mxint8_w8.03/a8.5", 8, 8, None),
               ("mxint6_w6.03/a8.5", 6, 8, None),
               ("mxint6_w6.03/a6.5", 6, 6, None),
               ("mxint4_w4.03/a6.5", 4, 6, None))
# the LM train phase: Llama-3-8B at full width cut to LM_TRAIN_LAYERS of
# its 32 layers (about 1.49 G parameters: with their gradients and AdamW
# moments about 24 GiB in float32), "off", batch 2 x 512 tokens; then the
# SMOKE config LM_SMOKE_STEPS steps on the card and on the CPU, the
# losses held to LM_SMOKE_LOSS_TOL relative (the f32 unembedding's sums
# run in another order on each device)
LM_TRAIN_LAYERS = 2
LM_TRAIN_STEPS = 4
LM_TRAIN_BATCH = 2
LM_TRAIN_SEQ = 512
LM_SMOKE_STEPS = 5
# measured on the H100 1.52e-7 (xLSTM: two float32 ulps of its 6.25
# loss; the others 7.6e-8), the same before and after AdamW's square
# roots went through float64 (PERF.md): the first step's loss differs
# already, so the gap is the forward's float32 sums (the unembedding's),
# which run in another order on each device
LM_SMOKE_LOSS_TOL = 2e-7
# train_full's steps without the config's remat, beside its own steps
REMAT_COMPARE_STEPS = 2
# the VLM, LLaVA-NeXT-Mistral-7B at full width and depth: VLM_BATCH
# requests of its 2880 vision positions and VLM_TEXT text tokens (3072 in
# all: the query-chunked prefill takes multiples of 1024), VLM_NEW_TOKENS
# new ones, max_len VLM_MAX_LEN; one 3072-position score with vision
# embeddings (the flash kernel).  Card against CPU at 1 layer with
# VLM_CPU_VISION vision positions: prompts of VLM_CPU_VISION +
# VLM_CPU_TEXT positions (the whole-row prefill) and a VLM_CPU_SCORE-
# position score (past 512 x 512 scores: the flash kernel).  Launches of
# the prefill (8 L + 1 and the projector's linear), a decode step (9 L +
# 1) and the score (9 L + 1 and the projector's linear) at 32 layers
VLM_BATCH = 4
VLM_TEXT = 192
VLM_NEW_TOKENS = 16
VLM_MAX_LEN = 4096
VLM_CPU_VISION = 448
VLM_CPU_TEXT = 64
VLM_CPU_SCORE = 576
VLM_LAUNCHES = {"prefill": 258, "decode": 289, "score": 290}
# the encoder-decoder, SeamlessM4T-medium at full width and depth:
# LM_BATCH requests of ENCDEC_FRAMES frames (the flash encoder) and of
# ENCDEC_SHORT_FRAMES (the whole-row encoder), ENCDEC_PROMPT prompt
# tokens, ENCDEC_NEW_TOKENS new ones, max_len ENCDEC_MAX_LEN; card
# against CPU at 1 + 1 layers at ENCDEC_CPU_FRAMES frames.  Launches of a
# prefill and a decode step (``encdec_launches``) by frame count: a
# prefill runs 12 encoder layers of 10 (2 RMSNorms, 6 linears, the GELU,
# the attention kernel), enc_norm, encode_kv's 24 linears, 12 decoder
# layers of 13 (3 RMSNorms, 8 linears, the GELU, the cross-attention's
# kernel) and the final RMSNorm: 302; a decode step the decoder layers
# with the decode kernel, 14 each, and the final RMSNorm: 169
ENCDEC_FRAMES = 1024
ENCDEC_SHORT_FRAMES = 256
ENCDEC_PROMPT = 16
ENCDEC_NEW_TOKENS = 16
ENCDEC_MAX_LEN = 512
ENCDEC_CPU_FRAMES = (256, 640)
ENCDEC_LAUNCHES = {1024: (302, 169), 256: (302, 169)}
# training the recurrent families: RecurrentGemma-2B at full width and 2
# of its 8 units (6 layers, with the tied 256000 x 2560 table about 1.2 G
# parameters; the whole model's 2.7 G with their gradients, AdamW moments
# and the float64 copies the products keep for the backward would pass
# the card's 80 GB), xLSTM-350M at full width and depth; REC_TRAIN_STEPS
# steps in "off" at batch REC_TRAIN_BATCH x REC_TRAIN_SEQ tokens; then
# each of REC_TRAIN_SMOKES trained LM_SMOKE_STEPS steps on the card and
# on the CPU
REC_TRAIN_UNITS = {"recurrentgemma_2b": 2, "xlstm_350m": None}
REC_TRAIN_STEPS = 3
REC_TRAIN_BATCH = 2
REC_TRAIN_SEQ = 256
REC_TRAIN_SMOKES = ("recurrentgemma_2b", "xlstm_350m",
                    "llava_next_mistral_7b", "seamless_m4t_medium")


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call time of ``fn`` on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The CPU sides of the card-against-CPU checks (the LMs', LLaVA's,
# Seamless's, the tp phase's) run after every timed phase, in a pool of
# worker processes, one per core of the card's host, each on
# ``CPU_THREADS`` torch threads: the plain versions' element-wise work
# hardly speeds up past one thread, so the checks run side by side rather
# than one after another.  Their card sides run in place; the inputs of
# the CPU side (parameters in shared memory) wait until then.
CPU_THREADS = 1


def _cpu_worker_init():
    import torch
    torch.set_num_threads(CPU_THREADS)
    warm_cpu(torch)


def _share(obj):
    """Move every CPU tensor in ``obj`` (dicts, lists, tuples and named
    tuples of them) into shared memory, in place.  Done before a job
    reaches the pool: the pool's feeder thread would otherwise move each
    storage while this thread still reads the tensor (a card side copying
    the same planes), which frees the memory under it."""
    import torch
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cpu":
            obj.share_memory_()
    elif isinstance(obj, dict):
        for v in obj.values():
            _share(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _share(v)
    return obj


def _cpu_job(threads, fn, args):
    import torch
    torch.set_num_threads(threads)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(CPU_THREADS)


class CpuChecks:
    """The CPU sides of the checks, in a pool of worker processes.
    ``start(workers)`` starts the pool; ``add(tag, fn, *args)`` moves the
    job's tensors into shared memory (``_share``), submits the job at once
    and returns its index, so the jobs run in the order they are added
    (``card_vs_cpu_phases`` adds the longest first); ``run`` waits for
    every result and closes the pool (``seconds``: from ``start`` to the
    last result); ``result(i)`` reads one.  A job runs on ``CPU_THREADS``
    threads, or on its ``CPU_JOB_THREADS``."""

    def __init__(self):
        self.futures, self.results = [], {}
        self.pool, self.t0, self.seconds = None, None, None

    def start(self, workers: int):
        import concurrent.futures as cf
        import torch.multiprocessing as mp
        self.t0 = time.perf_counter()
        self.pool = cf.ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("spawn"),
            initializer=_cpu_worker_init)

    def add(self, tag, fn, *args) -> int:
        self.futures.append(self.pool.submit(
            _cpu_job, CPU_JOB_THREADS.get(tag, CPU_THREADS), fn,
            _share(args)))
        return len(self.futures) - 1

    def run(self) -> float:
        for i, f in enumerate(self.futures):
            self.results[i] = f.result()
        self.pool.shutdown()
        self.seconds = time.perf_counter() - self.t0
        return self.seconds

    def result(self, i):
        return self.results[i]


CPU_CHECKS = CpuChecks()


# trace event categories of the device's own work: kernels, and for a
# whole batch or step also its copies and fills (the image upload)
KERNEL_CATS = ("kernel",)
BUSY_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(fn, iters: int):
    """The device's events (kernels, copies, fills) of ``iters`` calls of
    ``fn`` after one warm call, from an exported ``torch.profiler``
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "device_ms_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return [e for e in events if e.get("cat") in BUSY_CATS]


def device_ms(fn, iters: int = 20, cats=KERNEL_CATS):
    """Device time per call of ``fn``: the summed durations of the kernels
    it launches (with ``BUSY_CATS`` also its copies and fills), read from
    the events of a ``torch.profiler`` trace (the host work and gaps
    between launches that ``time_ms`` sees are left out); None where the
    trace holds no such event."""
    us = sum(e.get("dur", 0) for e in trace_events(fn, iters)
             if e.get("cat") in cats)
    return us / iters / 1e3 if us > 0 else None


def device_ops(fn, iters: int = 5):
    """Device operations (kernels, copies, fills) per call of ``fn``, with
    their names, from a ``torch.profiler`` trace; None where the trace
    holds no device event."""
    events = trace_events(fn, iters)
    if not events:
        return None, []
    return len(events) / iters, sorted({e.get("name", "") for e in events})


def idle_share(busy_ms, wall_ms):
    """The share of ``wall_ms`` in which the device ran none of the work
    (None where the trace gave no device time)."""
    return None if busy_ms is None else 1.0 - busy_ms / wall_ms


def reset_counts():
    from repro_torch.kernels import ops
    for m, attr in (*ops.LAUNCH_COUNTERS.values(),
                    *ops.ROUTE_COUNTERS.values()):
        setattr(m, attr, 0)


def read_routes():
    from repro_torch.kernels import ops
    return ops.route_counts()


def read_counts():
    from repro_torch.kernels import ops
    return ops.launch_counts()


def count_diff(after, before):
    return {n: after[n] - before[n] for n in after}


def flash_pairs(sq, sk, causal, window):
    """(query, key) pairs that the causal and window masks keep."""
    total = 0
    for i in range(sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(sk, i + 1) if causal else sk
        total += max(0, hi - lo)
    return total


def kernel_cases(torch, np):
    """name -> list of (label, kernel call, plain call, bound args,
    library call or None); the first case is the DeiT-Base one.  The
    llama3_8b cases are the variants the LM path runs: bf16 activations
    (read as f32), MXInt8 planes, RMSNorm, SiLU, K 14336 in one launch."""
    from repro_torch.core.mx_types import (MXINT6_WEIGHT, MXINT8_WEIGHT,
                                           NEG_INF)
    from repro_torch.core.quantize import dequantize, pack_weight
    from repro_torch.kernels import (mxint_gelu, mxint_layernorm,
                                     mxint_ln_matmul, mxint_matmul,
                                     mxint_softmax)
    from repro_torch.kernels.mxint_matmul import sm_count
    import torch.nn.functional as F
    rng = np.random.default_rng(SEED)
    dev = DEVICE

    def x(*shape, scale=1.0):
        a = rng.normal(size=shape).astype(np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)

    def planes(K, N, fmt=MXINT6_WEIGHT):
        return pack_weight(x(K, N, scale=K ** -0.5), fmt)

    def extreme_planes(K, N):
        """Mantissas at +-127 (all +127 in the first half of the columns)
        and exponents in [-8, 8], MXInt8's block of 256."""
        sign = np.where(rng.random((K, N)) < 0.5, -1, 1)
        sign[:, :N // 2] = 1
        return planes(K, N, MXINT8_WEIGHT)._replace(
            mantissa=torch.from_numpy((127 * sign).astype(np.int8)).to(dev),
            exponent=torch.from_numpy(rng.integers(
                -8, 9, size=(K // 256, N)).astype(np.int8)).to(dev))

    def extreme_rows(M, K):
        """Rows whose act blocks all quantize to mantissas +-127 (the
        first half of the rows all +127)."""
        sign = np.where(rng.random((M, K)) < 0.5, -1.0, 1.0)
        sign[:M // 2] = 1.0
        e = rng.integers(-4, 5, size=(M, K // 16, 1))
        a = (127.0 * sign.reshape(M, K // 16, 16) * 2.0 ** e).reshape(M, K)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def lm(label):
        return label.startswith(("llama3_8b", "mixtral", "granite",
                                 "deepseek", "recurrentgemma", "xlstm",
                                 "llava", "seamless"))

    rows = BATCH * 197
    S = LM_SCORE_TOKENS
    cases = {n: [] for n in REPLACES}
    # M 1, 16, 17, 33 and 200 straddle the 16-, 24- and 32-row tiles; K
    # 14336 at M 33 and 200 takes the K chunks; an odd N stages the
    # planes byte by byte and stores element by element; "subnormal"
    # scales the rows by 2^-120, so e_a + e_w < -126 (subnormal block
    # scales); "extreme" has every act and weight mantissa at +-127
    for label, M, K, N in (("deit_base_b16_ffn_wo", rows, 3072, 768),
                           ("ragged", 37, 192, 1000),
                           ("llama3_8b_decode_attn_wo", LM_BATCH, 4096, 4096),
                           ("llama3_8b_decode_ffn_wo", LM_BATCH, 14336, 4096),
                           ("llama3_8b_score_ffn_wo", S, 14336, 4096),
                           # the shapes of mxint_ln_matmul's decode, score
                           # and DeiT cases: its LN prologue's cost is the
                           # difference of the two kernels' times
                           ("llama3_8b_decode_k4096_n1024", LM_BATCH, 4096,
                            1024),
                           ("llama3_8b_decode_k4096_n14336", LM_BATCH, 4096,
                            14336),
                           ("llama3_8b_score_attn_wo", S, 4096, 4096),
                           ("deit_base_b16_ffn_wi_core", rows, 768, 3072),
                           ("m1_k4096_n1024", 1, 4096, 1024),
                           ("m16_k4096_n4096", 16, 4096, 4096),
                           ("m17_k768_n1001", 17, 768, 1001),
                           ("m33_k14336_n1024", 33, 14336, 1024),
                           ("m200_k14336_n4096", 200, 14336, 4096),
                           ("subnormal_m40_k768_n520", 40, 768, 520),
                           ("extreme_m48_k1024_n512", 48, 1024, 512),
                           # the MoE routers, narrower than any other N: a
                           # decode step's 4 rows and a 1024-token prefill
                           # bucket's; DeepSeek-67B's FFN out (K 22016)
                           ("mixtral_decode_router", LM_BATCH, 4096, 8),
                           ("mixtral_prefill_router", 1024, 4096, 8),
                           ("granite_decode_router", LM_BATCH, 1536, 40),
                           ("granite_prefill_router", 1024, 1536, 40),
                           ("deepseek_decode_ffn_wo", LM_BATCH, 22016,
                            8192),
                           # RecurrentGemma-2B: the RG-LRU's linears (its
                           # gates 2560 -> 2560), the GeGLU's out; xLSTM:
                           # the mLSTM gates, N 4 (the narrowest N), its
                           # q/k/v and up, and the sLSTM's linears, one
                           # token a row in a slot prefill's loop
                           ("recurrentgemma_decode_rglru_w_a", LM_BATCH,
                            2560, 2560),
                           ("recurrentgemma_prefill_rglru_w_a", 512, 2560,
                            2560),
                           ("recurrentgemma_decode_ffn_wo", LM_BATCH, 7680,
                            2560),
                           ("recurrentgemma_score_ffn_wo", S, 7680, 2560),
                           ("xlstm_decode_gate_w_f", LM_BATCH, 1024, 4),
                           ("xlstm_prefill_gate_w_f", 512, 1024, 4),
                           ("xlstm_decode_up", LM_BATCH, 1024, 2048),
                           ("xlstm_prefill_wq", 512, 1024, 1024),
                           ("xlstm_slstm_token_w_in", 1, 1024, 4096),
                           ("xlstm_decode_slstm_r_in", LM_BATCH, 1024,
                            4096),
                           # LLaVA's projector over a batch's 2880 vision
                           # positions a row (MXInt6: the config's weight
                           # format, packed at each call); SeamlessM4T's
                           # linears, d 1024 and d_ff 4096: a decode
                           # step's q (and cross q, out), encode_kv and
                           # the encoder's FFN over 4 x 1024 frames
                           ("llava_prefill_vision_proj", VLM_BATCH * 2880,
                            1024, 4096),
                           ("seamless_decode_wq", LM_BATCH, 1024, 1024),
                           ("seamless_decode_ffn_wo", LM_BATCH, 4096, 1024),
                           ("seamless_encode_kv", LM_BATCH * ENCDEC_FRAMES,
                            1024, 1024),
                           ("seamless_encoder_ffn_wi",
                            LM_BATCH * ENCDEC_FRAMES, 1024, 4096),
                           ("seamless_encoder_ffn_wo",
                            LM_BATCH * ENCDEC_FRAMES, 4096, 1024)):
        a = x(M, K)
        if lm(label):
            a = a.to(torch.bfloat16).to(torch.float32)
        w = planes(K, N, MXINT6_WEIGHT if label.startswith(
            ("deit", "llava_prefill_vision")) or label == "ragged"
            else MXINT8_WEIGHT)
        if label.startswith("subnormal"):
            a = a * 2.0 ** -120
        if label.startswith("extreme"):
            a, w = extreme_rows(M, K), extreme_planes(K, N)
        wd = dequantize(w)
        cases["mxint_matmul"].append((
            label,
            lambda a=a, w=w: mxint_matmul.mxint_matmul(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                quantize_act=True),
            lambda a=a, w=w: mxint_matmul.matmul_blocks(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=16, act_mant_bits=8),
            bound(M * K * 4 + w.mantissa.numel() + w.exponent.numel()
                  + M * N * 4, int8_ops=2.0 * M * N * K,
                  f32_ops=gemm_f32_ops(M, N, K)),
            lambda a=a, wd=wd: torch.matmul(a, wd)))
    # the row strategy's shards (the tp phase): each rank's K rows of the
    # K-sharded planes, packed with the block clamped to the per-rank K
    # (pack_params_mxint(tp_shards=2)): DeiT-Base's out-projection K 384
    # at block 192 and FFN wo K 1536 at block 256, DeiT-Tiny's
    # out-projection K 96 at block 96
    for label, M, K, N, block in (
            ("deit_base_b16_tp_row_attn_out", rows, 384, 768, 192),
            ("deit_base_b16_tp_row_ffn_wo", rows, 1536, 768, 256),
            ("deit_tiny_b16_tp_row_attn_out", rows, 96, 192, 96)):
        a = x(M, K)
        w = pack_weight(x(K, N, scale=K ** -0.5), dataclasses.replace(
            MXINT6_WEIGHT, block_size=block))
        assert w.block_size == block
        wd = dequantize(w)
        cases["mxint_matmul"].append((
            label,
            lambda a=a, w=w: mxint_matmul.mxint_matmul(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                quantize_act=True),
            lambda a=a, w=w: mxint_matmul.matmul_blocks(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=16, act_mant_bits=8),
            bound(M * K * 4 + w.mantissa.numel() + w.exponent.numel()
                  + M * N * 4, int8_ops=2.0 * M * N * K,
                  f32_ops=gemm_f32_ops(M, N, K)),
            lambda a=a, wd=wd: torch.matmul(a, wd)))
    # the LM runs RMSNorm (no beta) on bf16 rows and bf16 scales; M 1, 16,
    # 17, 33 and 500 straddle the row tiles, N 1001 is odd; "subnormal"
    # scales gamma and beta by 2^-120 (subnormal block scales); "extreme":
    # weight mantissas +-127
    for label, M, d, N in (("deit_base_b16_ln2_wi", rows, 768, 3072),
                           ("ragged", 37, 192, 200),
                           ("llama3_8b_decode_rms_wq", LM_BATCH, 4096, 4096),
                           ("llama3_8b_decode_rms_wk", LM_BATCH, 4096, 1024),
                           ("llama3_8b_decode_rms_wi", LM_BATCH, 4096, 14336),
                           ("llama3_8b_score_rms_wq", S, 4096, 4096),
                           ("llama3_8b_score_rms_wi", S, 4096, 14336),
                           ("llama3_8b_m1_rms_wk", 1, 4096, 1024),
                           ("m16_d4096_n4096", 16, 4096, 4096),
                           ("m17_d768_n1001", 17, 768, 1001),
                           ("m33_d4096_n1024", 33, 4096, 1024),
                           ("m500_d4096_n4096", 500, 4096, 4096),
                           ("subnormal_m40_d768_n520", 40, 768, 520),
                           ("extreme_m48_d1024_n512", 48, 1024, 512),
                           # the LN stage's scalar route: rows offset by 4
                           # bytes; a LayerNorm without beta (zero)
                           ("unaligned_m37_d768_n1001", 37, 768, 1001),
                           ("no_beta_ln_m24_d768_n256", 24, 768, 256),
                           # DeepSeek-67B's d 8192: RMS -> wq and -> wi
                           ("deepseek_decode_rms_wq", LM_BATCH, 8192, 8192),
                           ("deepseek_decode_rms_wi", LM_BATCH, 8192,
                            22016),
                           # RecurrentGemma-2B's attention q (2560), k and
                           # v (256: one KV head of 256), GeGLU's inputs
                           ("recurrentgemma_decode_rms_wq", LM_BATCH, 2560,
                            2560),
                           ("recurrentgemma_decode_rms_wk", LM_BATCH, 2560,
                            256),
                           ("recurrentgemma_decode_rms_wi", LM_BATCH, 2560,
                            7680),
                           ("recurrentgemma_score_rms_wi", S, 2560,
                            7680)):
        rms = lm(label)
        a, g = x(M, d, scale=2.0), 1.0 + 0.1 * x(d)
        b = None if rms or label.startswith("no_beta") else 0.1 * x(d)
        if rms:
            a, g = a.to(torch.bfloat16), g.to(torch.bfloat16)
        if label.startswith("subnormal"):
            g, b = g * 2.0 ** -120, b * 2.0 ** -120
        if label.startswith("unaligned"):
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].reshape(M, d)
            assert a.data_ptr() % 16 == 4
        w = planes(d, N, MXINT6_WEIGHT if label.startswith("deit") or
                   label == "ragged" else MXINT8_WEIGHT)
        if label.startswith("extreme"):
            w = extreme_planes(d, N)
        wd = dequantize(w)
        cases["mxint_ln_matmul"].append((
            label,
            lambda a=a, g=g, b=b, w=w, rms=rms:
                mxint_ln_matmul.mxint_ln_matmul(
                    a, g, b, w.mantissa, w.exponent, w_block=w.block_size,
                    rms_only=rms),
            lambda a=a, g=g, b=b, w=w, rms=rms: mxint_ln_matmul.ln_matmul_rows(
                a, g, torch.zeros_like(g) if b is None else b, w.mantissa,
                w.exponent, w_block=w.block_size, act_block=16, mant_bits=8,
                lut_bits=5, rms_only=rms),
            bound(a.numel() * a.element_size()
                  + (1 if b is None else 2) * d * g.element_size()
                  + w.mantissa.numel() + w.exponent.numel() + M * N * 4,
                  int8_ops=2.0 * M * N * d,
                  f32_ops=ROW_OPS["mxint_layernorm"] * M * d
                  + gemm_f32_ops(M, N, d)),
            lambda a=a, wd=wd: torch.matmul(a.to(torch.float32), wd)))
    # softmax: the DeiT scores, then every route (softmax_geometry): the
    # register route at act block 1 (per-lane counts 1-32), at blocks 12,
    # 15 and 16 (float4 where aligned, scalar on a row offset by 4 bytes),
    # its limit and one element past it; the long route up to the longest
    # row the whole-row path sends (ops.PAPER_MAX_SCORES); causal score
    # rows masked with NEG_INF as _paper_softmax_attention masks them
    for label, R, n, blk, qout, how in (
            ("deit_base_b16_scores", BATCH * 12 * 197, 197, 1, True, None),
            ("ragged", 37, 64, 16, True, None),
            ("deit_causal_masked_n197", 12 * 197, 197, 1, True, "causal"),
            ("causal_masked_n512_b16", 4 * 512, 512, 16, True, "causal"),
            ("n20_b1", 64, 20, 1, True, None),
            ("n33_b1", 64, 33, 1, True, None),
            ("n100_b1", 64, 100, 1, True, None),
            ("reg_limit_n1024_b1", 300, 1024, 1, True, None),
            ("long_n1025_b1", 300, 1025, 1, True, None),
            ("reg_limit_n1024_b16", 300, 1024, 16, True, None),
            ("long_n1040_b16", 300, 1040, 16, True, None),
            ("long_rows_2x262144_b16", 2, 262144, 16, True, None),
            ("b16_n256_raw", 256, 256, 16, False, None),
            ("b16_n256_quantized", 256, 256, 16, True, None),
            ("unaligned_b16_n256", 256, 256, 16, True, "offset"),
            ("b12_n96_raw", 100, 96, 12, False, None),
            ("b15_n300", 100, 300, 15, True, None),
            # MXInt6 and MXInt12 scores and probabilities
            ("mant6_deit_scores_n197_b1", 12 * 197, 197, 1, True, "mant6"),
            ("mant12_b16_n256", 256, 256, 16, True, "mant12"),
            # the MoE gates: the top-k router logits, rows of k with the
            # act block clamped to the row; rows of 2 take the scalar
            # route (a block of 2 is no float4), rows of 8 the float4
            # route and, 4 bytes off, the scalar one
            ("mixtral_decode_gates_4x2", LM_BATCH, 2, 2, True, None),
            ("mixtral_prefill_gates_1024x2", 1024, 2, 2, True, None),
            ("granite_decode_gates_4x8", LM_BATCH, 8, 8, True, None),
            ("granite_prefill_gates_1024x8", 1024, 8, 8, True, None),
            ("unaligned_granite_gates_1024x8", 1024, 8, 8, True, "offset"),
            # RecurrentGemma-2B's 512-token score: 10 heads' causal rows
            # of 512 keys
            ("recurrentgemma_score512_causal_n512_g10", 10 * 512, 512, 16,
             True, "causal"),
            # SeamlessM4T's whole-row attention: a decode step's cross-
            # attention, one query a head over 1024 and over 256 frames,
            # a 16-token prefill's, and the encoder at 256 frames
            ("seamless_decode_cross_n1024", LM_BATCH * 16, 1024, 16, True,
             None),
            ("seamless_decode_cross_n256", LM_BATCH * 16, 256, 16, True,
             None),
            ("seamless_prefill_cross_16x1024", LM_BATCH * 16 * 16, 1024, 16,
             True, None),
            ("seamless_encoder_256", LM_BATCH * 16 * 256, 256, 16, True,
             None)):
        a = x(R, n, scale=4.0)
        mb = MANT_BITS.get(how, 8)
        if how == "causal":
            keep = torch.arange(n, device=dev)[None, :] <= \
                (torch.arange(R, device=dev) % n)[:, None]
            a = torch.where(keep, a, NEG_INF)
        if how == "offset":        # rows that start 4 bytes past 16
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].reshape(R, n)
            assert a.data_ptr() % 16 == 4
        geom = mxint_softmax.softmax_geometry(R, n, blk,
                                              a.data_ptr() % 16 == 0)
        log(f"[kernel] mxint_softmax {label} route {geom}")
        lib = None
        if not cases["mxint_softmax"]:
            # the DeiT scores: one PyTorch call computes the float softmax
            def lib(a=a):
                return torch.softmax(a, dim=-1)
        elif label.startswith("seamless"):
            # beside it, SDPA of the whole attention whose scores these
            # rows are (bf16, head dim 64): what one PyTorch call takes
            # for the score product, a float softmax and P.V
            sq = R // (LM_BATCH * 16)
            qa, ka, va = (x(LM_BATCH, 16, m, 64).to(torch.bfloat16)
                          for m in (sq, n, n))

            def lib(qa=qa, ka=ka, va=va):
                return F.scaled_dot_product_attention(qa, ka, va)
        cases["mxint_softmax"].append((
            label,
            lambda a=a, blk=blk, q=qout, mb=mb: mxint_softmax.mxint_softmax(
                a, act_block=blk, mant_bits=mb, quantize_out=q),
            lambda a=a, blk=blk, q=qout, mb=mb: mxint_softmax.softmax_rows(
                a, act_block=blk, mant_bits=mb, r_bits=2, quantize_out=q),
            bound(2 * R * n * 4, f32_ops=ROW_OPS["mxint_softmax"] * R * n),
            lib))
    # GELU: act block 16 (the float4 route) at the DeiT and Llama shapes,
    # blocks 8 and 4 (float4, 2 and 1 lanes a block), and the scalar route:
    # blocks 1 (an odd width), 2 and 12, and block 16 on rows offset by 4
    # bytes; the LM's SwiGLU gate is SiLU of bf16 values
    for label, R, d, fn, blk, how in (
            ("deit_base_b16_ffn", rows, 3072, "gelu", 16, None),
            ("ragged", 37, 768, "gelu", 16, None),
            ("llama3_8b_decode_silu", LM_BATCH, 14336, "silu", 16, None),
            ("llama3_8b_score_silu", S, 14336, "silu", 16, None),
            ("b8_37x768", 37, 768, "gelu", 8, None),
            ("b4_37x768_silu", 37, 768, "silu", 4, None),
            ("b1_37x197", 37, 197, "gelu", 1, None),
            ("b2_37x194", 37, 194, "gelu", 2, None),
            ("b12_37x96", 37, 96, "gelu", 12, None),
            ("unaligned_b16_37x768", 37, 768, "gelu", 16, "offset"),
            ("mant6_37x768", 37, 768, "gelu", 16, "mant6"),
            ("mant12_37x768_silu", 37, 768, "silu", 16, "mant12"),
            # the MoE experts' SiLU over their (E x C, d_ff) capacity
            # buffers: Mixtral decode (C 8) and a 1024-token prefill
            # bucket (C 320), Granite decode (40 experts, C 8)
            ("mixtral_decode_experts_silu", 8 * 8, 14336, "silu", 16, None),
            ("mixtral_prefill_experts_silu", 8 * 320, 14336, "silu", 16,
             None),
            ("granite_decode_experts_silu", 40 * 8, 512, "silu", 16,
             None),
            # RecurrentGemma-2B: the RG-LRU's y branch (width 2560) and
            # the GeGLU gate (7680)
            ("recurrentgemma_decode_rglru_gelu", LM_BATCH, 2560, "gelu", 16,
             None),
            ("recurrentgemma_prefill_rglru_gelu", 512, 2560, "gelu", 16,
             None),
            ("recurrentgemma_decode_geglu", LM_BATCH, 7680, "gelu", 16,
             None),
            ("recurrentgemma_score_geglu", S, 7680, "gelu", 16, None),
            # SeamlessM4T's FFN GELU (d_ff 4096): a decode step's rows and
            # the encoder's 4 x 1024 frames
            ("seamless_decode_gelu", LM_BATCH, 4096, "gelu", 16, None),
            ("seamless_encoder_gelu", LM_BATCH * ENCDEC_FRAMES, 4096, "gelu",
             16, None)):
        a = x(R, d, scale=2.0)
        mb = MANT_BITS.get(how, 8)
        if lm(label):
            a = a.to(torch.bfloat16).to(torch.float32)
        if how == "offset":
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].reshape(R, d)
            assert a.data_ptr() % 16 == 4
        table, domain = mxint_gelu.gelu_table(fn, 5, 3.0)
        lut = mxint_layernorm.lut_tensor(table, dev)
        if a.is_cuda:
            geom = mxint_gelu.gelu_geometry(R * d, blk, sm_count(a.device),
                                            a.data_ptr() % 16 == 0)
            log(f"[kernel] mxint_gelu {label} route {geom}")
        cases["mxint_gelu"].append((
            label,
            lambda a=a, fn=fn, blk=blk, mb=mb: mxint_gelu.mxint_gelu(
                a, fn=fn, act_block=blk, mant_bits=mb),
            lambda a=a, lut=lut, dom=domain, blk=blk, mb=mb:
                mxint_gelu.gelu_rows(a, lut, act_block=blk, mant_bits=mb,
                                     domain=dom),
            bound(2 * R * d * 4, f32_ops=ROW_OPS["mxint_gelu"] * R * d),
            # the DeiT case: one PyTorch call computes the float GELU
            None if cases["mxint_gelu"] else
            (lambda a=a, fn=fn: (F.gelu(a) if fn == "gelu"
                                 else F.silu(a)))))
    # the LM's final RMSNorm: bf16 rows and scale as the model hands them,
    # no beta (decode: 4 rows; a prefill's: 1024); LayerNorm at d 4096;
    # every route of ln_geometry: float4 / bf16 quads at act blocks 16, 8
    # and 4, a block a thread at blocks 12 and 1 and on rows offset by 4
    # bytes, the global stage for a row too long for shared memory; raw
    # output at DeiT width; gamma and beta at 2^-120 (subnormal block
    # scales); the 40x outlier block that saturates the shifts; MXInt12
    # mantissas; bf16 rows with f32 scales; a LayerNorm without beta
    for label, R, d, blk, qout, how in (
            ("deit_base_b16_final_ln", rows, 768, 16, True, None),
            ("ragged", 37, 192, 16, False, None),
            ("llama3_8b_decode_final_rms", LM_BATCH, 4096, 16, True, "rms"),
            ("llama3_8b_prefill_final_rms", 1024, 4096, 16, True, "rms"),
            ("ln_64x4096", 64, 4096, 16, True, None),
            ("b8_37x768", 37, 768, 8, True, None),
            ("b4_37x768_rms_bf16", 37, 768, 4, True, "rms"),
            ("b12_37x768", 37, 768, 12, True, None),
            ("b1_37x197", 37, 197, 1, True, None),
            ("unaligned_b16_37x768", 37, 768, 16, True, "offset"),
            ("global_stage_3x65536", 3, 65536, 16, True, None),
            ("deit_width_raw_300x768", 300, 768, 16, False, None),
            ("subnormal_scales_40x768", 40, 768, 16, True, "subnormal"),
            ("outlier_block_37x768", 37, 768, 16, True, "outlier"),
            ("mant12_37x768", 37, 768, 16, True, "mant12"),
            ("mant6_37x768", 37, 768, 16, True, "mant6"),
            # Qwen3-14B's per-head q and k RMSNorm: bf16 rows of 128 (a
            # decode step's 4 x 40 and 4 x 8 heads, a 1024-token prefill's
            # 1024 x 40)
            ("qwen3_14b_decode_q_norm", LM_BATCH * 40, 128, 16, True, "rms"),
            ("qwen3_14b_decode_k_norm", LM_BATCH * 8, 128, 16, True, "rms"),
            ("qwen3_14b_prefill_q_norm", 1024 * 40, 128, 16, True, "rms"),
            ("bf16_rows_f32_scales_37x768", 37, 768, 16, True, "mixed"),
            ("no_beta_ln_37x768", 37, 768, 16, True, "no_beta"),
            # the MoE layers' RMSNorm before the FFN (no fused linear
            # follows it): a decode step's bf16 rows
            ("mixtral_decode_ln2_rms", LM_BATCH, 4096, 16, True, "rms"),
            ("granite_decode_ln2_rms", LM_BATCH, 1536, 16, True, "rms"),
            # the pre-norm of every rec, mlstm and slstm block (no fused
            # linear follows it): RecurrentGemma d 2560, xLSTM d 1024
            ("recurrentgemma_decode_rms", LM_BATCH, 2560, 16, True, "rms"),
            ("recurrentgemma_prefill_rms", 512, 2560, 16, True, "rms"),
            ("xlstm_decode_rms", LM_BATCH, 1024, 16, True, "rms"),
            ("xlstm_prefill_rms", 512, 1024, 16, True, "rms"),
            # SeamlessM4T's every norm (no fused linear follows any): d
            # 1024, a decode step's rows and the encoder's frames
            ("seamless_decode_rms", LM_BATCH, 1024, 16, True, "rms"),
            ("seamless_encoder_rms", LM_BATCH * ENCDEC_FRAMES, 1024, 16,
             True, "rms")):
        rms = how == "rms"
        a, g = x(R, d, scale=2.0), 1.0 + 0.1 * x(d)
        b = None if rms or how == "no_beta" else 0.1 * x(d)
        mb = MANT_BITS.get(how, 8)
        if rms:
            a, g = a.to(torch.bfloat16), g.to(torch.bfloat16)
        if how == "mixed":
            a = a.to(torch.bfloat16)
        if how == "subnormal":
            g, b = g * 2.0 ** -120, b * 2.0 ** -120
        if how == "outlier":
            a[0, :16] *= 40.0
        if how == "offset":        # rows that start 4 bytes past 16
            a = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].reshape(R, d)
            assert a.data_ptr() % 16 == 4
        if a.is_cuda:
            geom = mxint_layernorm.ln_geometry(
                R, d, blk, sm_count(a.device),
                mxint_layernorm.aligned4(a, g, b))
            log(f"[kernel] mxint_layernorm {label} route {geom.route} "
                f"{geom}")
        cases["mxint_layernorm"].append((
            label,
            lambda a=a, g=g, b=b, q=qout, blk=blk, mb=mb, rms=rms:
                mxint_layernorm.mxint_layernorm(
                    a, g, b, act_block=blk, mant_bits=mb, rms_only=rms,
                    quantize_out=q),
            lambda a=a, g=g, b=b, q=qout, blk=blk, mb=mb, rms=rms:
                mxint_layernorm.layernorm_rows(
                    a.to(torch.float32), g,
                    torch.zeros_like(g) if b is None else b, act_block=blk,
                    mant_bits=mb, lut_bits=5, rms_only=rms, quantize_out=q),
            bound(a.numel() * a.element_size() + R * d * 4
                  + (1 if b is None else 2) * d * g.element_size(),
                  f32_ops=ROW_OPS["mxint_layernorm"] * R * d),
            # the DeiT case: one PyTorch call computes the float LayerNorm
            # (RMSNorm where the case is RMS)
            None if cases["mxint_layernorm"] else
            (lambda a=a, g=g, b=b, rms=rms, d=d:
                F.rms_norm(a, (d,), g) if rms else
                F.layer_norm(a, (d,), g, b))))
    widened_cases(torch, cases, x, planes, rows)
    segment_cases(torch, cases, x, rows)
    cases.update(flash_cases(torch, np, x))
    generic_route_cases(torch, cases, x, rows)
    return cases


# the formats the GEMM core takes by segment (V 3-4 of
# csrc/mxint_common.cuh): int16 planes and act blocks that do not nest in
# the weight block, as (tag, weight format, act format (bits, block)[, LN
# LUT bits]); each at DeiT-Base batch 16's FFN shapes (timed) and at a
# decode batch of 4 rows, and the former generic cases of these formats at
# 64 rows (``launch_contracts.CORE_SEGMENT_LABELS``).  The served widened
# format's two GEMMs keep the labels their generic cases had.
SEGMENT_MM = (("w12_a12", (12, 256), (8, 12)),
              ("w12_a8_b16", (12, 256), (8, 16)),
              ("w12_a12b16", (12, 256), (12, 16)),
              ("w8_a8_b24_w96", (8, 96), (8, 24)))
SEGMENT_LNMM = (("w12_a12_lut13", (12, 256), (8, 12), 13),
                ("w12_a12b16_lut13", (12, 256), (12, 16), 13))
SEGMENT_FORMER = (("odd_act_block_12", (8, 256), (8, 12)),
                  ("odd_act_block_24", (8, 96), (8, 24)),
                  ("act_block_512", (8, 512), (8, 512)),
                  ("int16_planes", (12, 256), (8, 16)))
TIMED_CASES |= {f"deit_base_b16_ffn_wo_{t}" for t, *_ in SEGMENT_MM} | {
    f"deit_base_b16_ln2_wi_{t}" for t, *_ in SEGMENT_LNMM}


def segment_cases(torch, cases, x, rows):
    """The GEMM core's segment cases (``SEGMENT_MM``, ``SEGMENT_LNMM``,
    ``SEGMENT_FORMER``) under ``mxint_matmul`` and ``mxint_ln_matmul``:
    each launches the core (``kernel_phase`` checks the route counts) and
    matches its plain version with 0 mismatches.  The bound counts the
    products split into int8 pieces (``int8_splits``) and a multiply and
    an add per output element and segment."""
    from repro_torch.core.mx_types import MXFormat
    from repro_torch.core.quantize import dequantize, pack_weight
    from repro_torch.kernels import mxint_ln_matmul, mxint_matmul
    from repro_torch.kernels.mxint_matmul import segments
    d, ff = 768, 3072
    mm = [(f"deit_base_b16_ffn_wo_{t}", rows, w, a) for t, w, a in SEGMENT_MM]
    mm += [(f"decode4_ffn_wo_{t}", LM_BATCH, w, a) for t, w, a in SEGMENT_MM]
    mm += [(t, 64, w, a) for t, w, a in SEGMENT_FORMER]
    for label, M, wf, (bits, blk) in mm:
        a = x(M, ff)
        w = pack_weight(x(ff, d, scale=ff ** -0.5), MXFormat(*wf))
        wd = dequantize(w)
        wb = w.mantissa.element_size()
        nseg = len(segments(ff, w.block_size, blk)[0])
        cases["mxint_matmul"].append((
            label,
            lambda a=a, w=w, blk=blk, bits=bits: mxint_matmul.mxint_matmul(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=blk, act_mant_bits=bits, quantize_act=True),
            lambda a=a, w=w, blk=blk, bits=bits: mxint_matmul.matmul_blocks(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=blk, act_mant_bits=bits),
            bound(a.numel() * 4 + w.mantissa.numel() * wb
                  + w.exponent.numel() + M * d * 4,
                  int8_ops=int8_splits(bits, wb) * 2.0 * M * d * ff,
                  f32_ops=2.0 * M * d * nseg),
            lambda a=a, wd=wd: torch.matmul(a, wd)))
    ln = [(f"deit_base_b16_ln2_wi_{t}", rows, w, a, lb)
          for t, w, a, lb in SEGMENT_LNMM]
    ln += [(f"decode4_ln2_wi_{t}", LM_BATCH, w, a, lb)
           for t, w, a, lb in SEGMENT_LNMM]
    for label, M, wf, (bits, blk), lb in ln:
        a, g, b = x(M, d, scale=2.0), 1.0 + 0.1 * x(d), 0.1 * x(d)
        w = pack_weight(x(d, ff, scale=d ** -0.5), MXFormat(*wf))
        wd = dequantize(w)
        wb = w.mantissa.element_size()
        nseg = len(segments(d, w.block_size, blk)[0])
        cases["mxint_ln_matmul"].append((
            label,
            lambda a=a, g=g, b=b, w=w, blk=blk, bits=bits, lb=lb:
                mxint_ln_matmul.mxint_ln_matmul(
                    a, g, b, w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, mant_bits=bits, lut_bits=lb),
            lambda a=a, g=g, b=b, w=w, blk=blk, bits=bits, lb=lb:
                mxint_ln_matmul.ln_matmul_rows(
                    a, g, b, w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, mant_bits=bits, lut_bits=lb,
                    rms_only=False),
            bound(a.numel() * 4 + 2 * d * 4 + 4 * 2 ** lb
                  + w.mantissa.numel() * wb + w.exponent.numel()
                  + M * ff * 4,
                  int8_ops=int8_splits(bits, wb) * 2.0 * M * ff * d,
                  f32_ops=ROW_OPS["mxint_layernorm"] * M * d
                  + 2.0 * M * ff * nseg),
            lambda a=a, wd=wd: torch.matmul(a, wd)))


# the generic routes' cases: every format the fast routes and the GEMM
# core do not take (``launch_contracts.generic_cases``, the out-of-domain
# formats before the generic routes, less ``CORE_SEGMENT_LABELS``) and the
# served widened formats' shapes (17-bit acts at DeiT-Base batch 16, the
# generic GEMMs' served format; act block 12 and Table VI's vanilla LUTs
# for the row kernels), float activations at DeiT-Base's FFN wo, the
# flash kernels' r 10 LUT, and int16 planes the core refuses (a weight
# block of 8: the generic GEMM's int32 dots; W12 x A12 at act block 64:
# its int64 dots) for both GEMM kernels; all timed, all held to 0
# mismatches
GENERIC_LABELS = (
    "deit_base_b16_ffn_wo_a17", "k_not_16", "act_mant_17",
    "w24_a24_int32", "w12_a12_b64_int16_wide", "w12_w_block_8_int16",
    "deit_base_b16_ffn_wo_float_act", "deit_base_b16_ln2_wi_a17",
    "odd_act_block_48", "lnmm_unaligned_block_32",
    "lnmm_w12_a12_b64_int16_wide", "lnmm_w12_w_block_8_int16", "deit_base_b16_final_ln_a12_lut13",
    "ln_block_24", "ln_block_256", "ln_unaligned_block_32",
    "deit_base_b16_softmax_r16", "softmax_block_256",
    "deit_base_b16_gelu_a12_lut14", "gelu_block_256", "flash_r10",
    "flash_act_block_64", "flash_head_dim_272", "flash_bf16_head_dim_100",
    "flash_groups_129", "decode_act_block_12", "decode_head_dim_272",
    "llama3_8b_score_1024_act_block_64", "decode_act_block_64")
TIMED_CASES |= set(GENERIC_LABELS)


def offset_rows(torch, a):
    """``a`` copied into a buffer one element past its start: rows that
    start 4 (f32) bytes off a 16-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


def generic_route_cases(torch, cases, x, rows):
    """The generic routes' cases (``GENERIC_LABELS``) under the kernels'
    names with ``/generic``, and the one former out-of-domain decode
    format the fast decode kernel now takes (act block 12 resolves to 8)
    under ``flash_attention_decode``."""
    import torch.nn.functional as F
    from repro_torch.core.mx_types import MXINT6_WEIGHT, MXFormat
    from repro_torch.core.quantize import dequantize, pack_weight
    from repro_torch.kernels import (flash_attention as fa, mxint_gelu,
                                     mxint_layernorm, mxint_ln_matmul,
                                     mxint_matmul, mxint_softmax)
    from repro_torch.kernels.mxint_matmul import segments
    out = {f"{n}/generic": [] for n in REPLACES}
    M, d, ff = 64, 768, 3072

    def planes(K, N, fmt):
        return pack_weight(x(K, N, scale=K ** -0.5), fmt)

    # mxint_matmul: (label, M, K, N, weight format, act block, bits,
    # quantize_act); case 0 is the served 17-bit acts' FFN wo
    for label, m, K, N, fmt, blk, bits, qa in (
            ("deit_base_b16_ffn_wo_a17", rows, ff, d, MXINT6_WEIGHT,
             *WIDE_GEN_ACT[::-1], True),
            ("k_not_16", M, 200, d, MXFormat(8, 8), 8, 8, True),
            ("act_mant_17", M, ff, d, MXFormat(8, 256), 16, 17, True),
            ("w24_a24_int32", M, ff, d, MXFormat(24, 256), 256, 24, True),
            ("w12_a12_b64_int16_wide", M, ff, d, MXFormat(12, 256), 64, 12,
             True),
            ("w12_w_block_8_int16", M, ff, d, MXFormat(12, 8), 8, 8, True),
            ("deit_base_b16_ffn_wo_float_act", rows, ff, d,
             MXFormat(6, 256), 16, 8, False)):
        a, w = x(m, K), planes(K, N, fmt)
        wd = dequantize(w)
        nbytes = (a.numel() * 4 + w.mantissa.numel() *
                  w.mantissa.element_size() + w.exponent.numel() + m * N * 4)
        nseg = len(segments(K, w.block_size, blk)[0])
        out["mxint_matmul/generic"].append((
            label,
            lambda a=a, w=w, blk=blk, bits=bits, qa=qa:
                mxint_matmul.mxint_matmul(
                    a, w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, act_mant_bits=bits, quantize_act=qa),
            (lambda a=a, w=w, blk=blk, bits=bits: mxint_matmul.matmul_blocks(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=blk, act_mant_bits=bits)) if qa else
            (lambda a=a, w=w: mxint_matmul.matmul_float(
                a, w.mantissa, w.exponent, w_block=w.block_size)),
            bound(nbytes, int8_ops=int8_splits(
                      bits, w.mantissa.element_size()) * 2.0 * m * N * K
                  if qa else 0.0, f32_ops=2.0 * m * N * nseg if qa else 0.0,
                  f64_ops=0.0 if qa else 2.0 * m * N * K),
            (lambda a=a, wd=wd: torch.matmul(a, wd)) if m == rows else None))
    # mxint_ln_matmul: (label, M, d, N, format, act block, bits, LUT bits,
    # unaligned rows); case 0 is the served 17-bit acts' LN2 -> wi
    for label, m, dd, N, fmt, blk, bits, lb, off in (
            ("deit_base_b16_ln2_wi_a17", rows, d, ff, MXINT6_WEIGHT,
             *WIDE_GEN_ACT[::-1], 5, False),
            ("odd_act_block_48", M, d, ff, MXFormat(8, 96), 48, 8, 5, False),
            ("lnmm_unaligned_block_32", M, d, ff, MXFormat(8, 256), 32, 8, 5,
             True),
            ("lnmm_w12_a12_b64_int16_wide", M, d, ff, MXFormat(12, 256), 64,
             12, 5, False),
            ("lnmm_w12_w_block_8_int16", M, d, ff, MXFormat(12, 8), 8, 8, 5,
             False)):
        a, g, b = x(m, dd, scale=2.0), 1.0 + 0.1 * x(dd), 0.1 * x(dd)
        if off:
            a = offset_rows(torch, a)
        w = planes(dd, N, fmt)
        wd = dequantize(w)
        nseg = len(segments(dd, w.block_size, blk)[0])
        out["mxint_ln_matmul/generic"].append((
            label,
            lambda a=a, g=g, b=b, w=w, blk=blk, bits=bits, lb=lb:
                mxint_ln_matmul.mxint_ln_matmul(
                    a, g, b, w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, mant_bits=bits, lut_bits=lb),
            lambda a=a, g=g, b=b, w=w, blk=blk, bits=bits, lb=lb:
                mxint_ln_matmul.ln_matmul_rows(
                    a, g, b, w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, mant_bits=bits, lut_bits=lb,
                    rms_only=False),
            bound(a.numel() * 4 + 2 * dd * 4 + 4 * 2 ** lb +
                  w.mantissa.numel() * w.mantissa.element_size() +
                  w.exponent.numel() + m * N * 4,
                  int8_ops=int8_splits(bits, w.mantissa.element_size())
                  * 2.0 * m * N * dd,
                  f32_ops=ROW_OPS["mxint_layernorm"] * m * dd
                  + 2.0 * m * N * nseg),
            (lambda a=a, wd=wd: torch.matmul(a, wd)) if m == rows else None))
    for label, m, blk, lb, off in (
            ("deit_base_b16_final_ln_a12_lut13", rows, 12, 13, False),
            ("ln_block_24", M, 24, 5, False), ("ln_block_256", M, 256, 5,
                                                False),
            ("ln_unaligned_block_32", M, 32, 5, True)):
        a, g, b = x(m, d, scale=2.0), 1.0 + 0.1 * x(d), 0.1 * x(d)
        if off:
            a = offset_rows(torch, a)
        out["mxint_layernorm/generic"].append((
            label,
            lambda a=a, g=g, b=b, blk=blk, lb=lb:
                mxint_layernorm.mxint_layernorm(
                    a, g, b, act_block=blk, lut_bits=lb, quantize_out=True),
            lambda a=a, g=g, b=b, blk=blk, lb=lb:
                mxint_layernorm.layernorm_rows(
                    a, g, b, act_block=blk, mant_bits=8, lut_bits=lb,
                    rms_only=False, quantize_out=True),
            bound(2 * a.numel() * 4 + 2 * d * 4 + 4 * 2 ** lb,
                  f32_ops=ROW_OPS["mxint_layernorm"] * a.numel()),
            (lambda a=a, g=g, b=b: F.layer_norm(a, (d,), g, b))
            if m == rows else None))
    for label, R, n, blk, rb in (
            ("deit_base_b16_softmax_r16", BATCH * 12 * 197, 197, 1, 16),
            ("softmax_block_256", M, 256, 256, 2)):
        a = x(R, n, scale=4.0)
        out["mxint_softmax/generic"].append((
            label,
            lambda a=a, blk=blk, rb=rb: mxint_softmax.mxint_softmax(
                a, act_block=blk, r_bits=rb, quantize_out=True),
            lambda a=a, blk=blk, rb=rb: mxint_softmax.softmax_rows(
                a, act_block=blk, mant_bits=8, r_bits=rb, quantize_out=True),
            bound(2 * a.numel() * 4 + 4 * 2 ** rb,
                  f32_ops=ROW_OPS["mxint_softmax"] * a.numel()),
            (lambda a=a: torch.softmax(a, dim=-1)) if R > M else None))
    for label, m, blk, lb in (("deit_base_b16_gelu_a12_lut14", rows, 12, 14),
                              ("gelu_block_256", M, 256, 5)):
        a = x(m, ff, scale=2.0)
        table, dom = mxint_gelu.gelu_table("gelu", lb, 3.0)
        lut = mxint_layernorm.lut_tensor(table, a.device)
        out["mxint_gelu/generic"].append((
            label,
            lambda a=a, blk=blk, lb=lb: mxint_gelu.mxint_gelu(
                a, act_block=blk, lut_bits=lb),
            lambda a=a, lut=lut, dom=dom, blk=blk: mxint_gelu.gelu_rows(
                a, lut, act_block=blk, mant_bits=8, domain=dom),
            bound(2 * a.numel() * 4 + 4 * len(table),
                  f32_ops=ROW_OPS["mxint_gelu"] * a.numel()),
            (lambda a=a: F.gelu(a)) if m == rows else None))
    bf16 = torch.bfloat16
    mx = dict(exp_mode="mxint", quantize_scores=True)
    # flash_attention: (label, heads, S, keys, head dim, G, act block,
    # r_bits); case 0 is the widened LM's 1024-token score
    # (``widened_lm_phase``: 32 query heads over 8, act block 64)
    for label, h, S, sk, dd, g, blk, rb in (
            ("llama3_8b_score_1024_act_block_64", 32, LM_SCORE_TOKENS,
             LM_SCORE_TOKENS, 128, 4, WIDE_LM_ACT[1], 2),
            ("flash_r10", 8, 256, 256, 128, 1, 16, 10),
            ("flash_act_block_64", 8, 256, 256, 128, 1, 64, 2),
            ("flash_head_dim_272", 8, 256, 256, 272, 1, 16, 2),
            ("flash_bf16_head_dim_100", 8, 256, 256, 100, 1, 16, 2),
            ("flash_groups_129", 129, 16, 256, 128, 129, 16, 2)):
        hkv = h // g
        q = x(h, S, dd, scale=1.5).to(bf16)
        k = x(hkv, sk, dd, scale=1.5).to(bf16)
        v = x(hkv, sk, dd).to(bf16)
        pairs = h * flash_pairs(S, sk, True, 0)
        out["flash_attention/generic"].append((
            label,
            lambda q=q, k=k, v=v, g=g, blk=blk, rb=rb: fa.flash_attention(
                q, k, v, causal=True, kv_groups=g, act_block=blk, r_bits=rb,
                **mx),
            lambda q=q, k=k, v=v, g=g, blk=blk, rb=rb: fa.flash_rows(
                q, k, v, causal=True, window=0, kv_groups=g, r_bits=rb,
                act_block=fa.resolve_act_block(blk), mant_bits=8,
                scale=fa.f32(q.shape[-1] ** -0.5), **mx).to(q.dtype),
            bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                  bf16_ops=4.0 * dd * pairs, f32_ops=ROW_OPS["flash"] * pairs),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, enable_gqa=True)))
    # flash_attention_decode: (label, ring, KV heads, G, head dim, act
    # block); the valid slots of the 4 batch rows; case 0 of the generic
    # route is the widened LM's decode step (``widened_lm_phase``)
    for label, W, hkv, g, dd, blk in (
            ("decode_act_block_64", LM_MAX_LEN, 8, 4, 128, WIDE_LM_ACT[1]),
            ("decode_act_block_12", 2048, 8, 4, 128, 12),
            ("decode_head_dim_272", 2048, 8, 4, 272, 16)):
        q = x(4, hkv, g, dd, scale=1.5).to(bf16)
        k = x(4, W, hkv, dd, scale=1.5).to(bf16)
        v = x(4, W, hkv, dd).to(bf16)
        valid = torch.zeros(4, W, dtype=torch.int32, device=DEVICE)
        for i, n in enumerate((61, 300, 700, 1024)):
            valid[i, :n] = 1
        n_valid = int(valid.sum())
        pairs = n_valid * hkv * g
        mask = (valid != 0)[:, None, None, :]
        key = "flash_attention_decode" + (
            "" if label == "decode_act_block_12" else "/generic")
        (cases if key in cases else out)[key].append((
            label,
            lambda q=q, k=k, v=v, valid=valid, blk=blk:
                fa.flash_attention_decode(q, k, v, valid, act_block=blk,
                                          **mx),
            lambda q=q, k=k, v=v, valid=valid, blk=blk, dd=dd:
                fa.decode_rows(q, k, v, valid, r_bits=2,
                               act_block=fa.resolve_act_block(blk),
                               mant_bits=8, scale=fa.f32(dd ** -0.5),
                               **mx).to(q.dtype),
            bound(n_valid * hkv * dd * 2 * 2 + 2 * q.numel() * 2
                  + valid.numel() * 4,
                  bf16_ops=4.0 * dd * pairs, f32_ops=ROW_OPS["flash"] * pairs),
            lambda q=q, k=k, v=v, mask=mask, hkv=hkv, g=g, dd=dd:
                F.scaled_dot_product_attention(
                    q.reshape(4, hkv * g, 1, dd), k.transpose(1, 2),
                    v.transpose(1, 2), attn_mask=mask, enable_gqa=True)))
    cases.update(out)


def widened_cases(torch, cases, x, planes, rows):
    """The act formats past block 16 and 8 bits (``WIDE_ACT``): the matmul
    kernels at act blocks 4, 8, 32, 64 and 256 and at act mantissas of 10,
    12 and 16 bits (at blocks 16 and 32), at DeiT-Base's FFN ``wo`` / LN2
    -> ``wi`` and a Llama decode shape; the row kernels at act blocks 32,
    64 and 128 at the DeiT shapes (softmax on rows of 256: DeiT's 197 is
    prime, so its act block resolves to 1)."""
    from repro_torch.core.mx_types import MXINT6_WEIGHT, MXINT8_WEIGHT
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels import (mxint_gelu, mxint_layernorm,
                                     mxint_ln_matmul, mxint_matmul,
                                     mxint_softmax)
    for (label, M, K, N), (blk, mb) in ((s, f) for s in (
            ("deit_base_b16_ffn_wo", rows, 3072, 768),
            ("llama3_8b_decode_attn_wo", LM_BATCH, 4096, 4096))
            for f in WIDE_ACT):
        a = x(M, K)
        w = planes(K, N, MXINT6_WEIGHT if label.startswith("deit")
                   else MXINT8_WEIGHT)
        wd = dequantize(w)
        cases["mxint_matmul"].append((
            f"{label}_a{blk}_m{mb}",
            lambda a=a, w=w, blk=blk, mb=mb: mxint_matmul.mxint_matmul(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=blk, act_mant_bits=mb, quantize_act=True),
            lambda a=a, w=w, blk=blk, mb=mb: mxint_matmul.matmul_blocks(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=blk, act_mant_bits=mb),
            bound(M * K * 4 + w.mantissa.numel() + w.exponent.numel()
                  + M * N * 4, int8_ops=(2.0 if mb > 8 else 1.0)
                  * 2.0 * M * N * K, f32_ops=gemm_f32_ops(M, N, K, blk)),
            lambda a=a, wd=wd: torch.matmul(a, wd)))
    for (label, M, d, N), (blk, mb) in ((s, f) for s in (
            ("deit_base_b16_ln2_wi", rows, 768, 3072),
            ("llama3_8b_decode_rms_wq", LM_BATCH, 4096, 4096))
            for f in WIDE_ACT):
        rms = label.startswith("llama")
        a, g = x(M, d, scale=2.0), 1.0 + 0.1 * x(d)
        b = None if rms else 0.1 * x(d)
        if rms:
            a, g = a.to(torch.bfloat16), g.to(torch.bfloat16)
        w = planes(d, N, MXINT8_WEIGHT if rms else MXINT6_WEIGHT)
        wd = dequantize(w)
        cases["mxint_ln_matmul"].append((
            f"{label}_a{blk}_m{mb}",
            lambda a=a, g=g, b=b, w=w, rms=rms, blk=blk, mb=mb:
                mxint_ln_matmul.mxint_ln_matmul(
                    a, g, b, w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, mant_bits=mb, rms_only=rms),
            lambda a=a, g=g, b=b, w=w, rms=rms, blk=blk, mb=mb:
                mxint_ln_matmul.ln_matmul_rows(
                    a, g, torch.zeros_like(g) if b is None else b,
                    w.mantissa, w.exponent, w_block=w.block_size,
                    act_block=blk, mant_bits=mb, lut_bits=5, rms_only=rms),
            bound(a.numel() * a.element_size()
                  + (1 if b is None else 2) * d * g.element_size()
                  + w.mantissa.numel() + w.exponent.numel() + M * N * 4,
                  int8_ops=(2.0 if mb > 8 else 1.0) * 2.0 * M * N * d,
                  f32_ops=ROW_OPS["mxint_layernorm"] * M * d
                  + gemm_f32_ops(M, N, d, blk)),
            lambda a=a, wd=wd: torch.matmul(a.to(torch.float32), wd)))
    for blk in WIDE_ROW_BLOCKS:
        R, n = BATCH * 12 * 197, 256
        a = x(R, n, scale=4.0)
        log(f"[kernel] mxint_softmax deit_rows_n256_b{blk} route "
            f"{mxint_softmax.softmax_geometry(R, n, blk)}")
        cases["mxint_softmax"].append((
            f"deit_rows_n256_b{blk}",
            lambda a=a, blk=blk: mxint_softmax.mxint_softmax(
                a, act_block=blk, quantize_out=True),
            lambda a=a, blk=blk: mxint_softmax.softmax_rows(
                a, act_block=blk, mant_bits=8, r_bits=2, quantize_out=True),
            bound(2 * R * n * 4, f32_ops=ROW_OPS["mxint_softmax"] * R * n),
            None))
        a = x(rows, 3072, scale=2.0)
        table, domain = mxint_gelu.gelu_table("gelu", 5, 3.0)
        lut = mxint_layernorm.lut_tensor(table, a.device)
        cases["mxint_gelu"].append((
            f"deit_base_b16_ffn_b{blk}",
            lambda a=a, blk=blk: mxint_gelu.mxint_gelu(a, act_block=blk),
            lambda a=a, lut=lut, dom=domain, blk=blk: mxint_gelu.gelu_rows(
                a, lut, act_block=blk, mant_bits=8, domain=dom),
            bound(2 * a.numel() * 4, f32_ops=ROW_OPS["mxint_gelu"]
                  * a.numel()),
            None))
        a, g, b = x(rows, 768, scale=2.0), 1.0 + 0.1 * x(768), 0.1 * x(768)
        cases["mxint_layernorm"].append((
            f"deit_base_b16_final_ln_b{blk}",
            lambda a=a, g=g, b=b, blk=blk: mxint_layernorm.mxint_layernorm(
                a, g, b, act_block=blk, quantize_out=True),
            lambda a=a, g=g, b=b, blk=blk: mxint_layernorm.layernorm_rows(
                a, g, b, act_block=blk, mant_bits=8, lut_bits=5,
                rms_only=False, quantize_out=True),
            bound(2 * a.numel() * 4 + 2 * 768 * 4,
                  f32_ops=ROW_OPS["mxint_layernorm"] * a.numel()),
            None))


def flash_cases(torch, np, x):
    """The two flash kernels at the Llama-3-8B shapes (bf16, mxint with
    quantized scores, then float), at the served ring depths, at
    Phi-4-mini's and Qwen3-14B's group counts (G 3 and 5) and at ragged
    shapes: rings that wrapped or have holes, G 1 and 8, head dims that are
    not multiples of 16, act blocks 4 and 32, float32 operands."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dev = DEVICE
    bf16, f32 = torch.bfloat16, torch.float32
    mx = dict(exp_mode="mxint", quantize_scores=True)
    fl = dict(exp_mode="float", quantize_scores=False)
    mx6, mx12 = dict(mx, mant_bits=6), dict(mx, mant_bits=12)
    cases = {"flash_attention_decode": [], "flash_attention": []}
    depths = ((0, 37), (0, 700), (0, 1500), (0, 2048))
    ragged = ((0, 37), (0, 120), (0, 299), (0, 300))
    # (label, W, KV heads, G, head dim, act block, dtype, kw, the valid
    # slots of each of the 4 batch rows as (first, end[, hole first, hole
    # end]))
    for label, W, hkv, g, d, blk, dt, kw, rows in (
            ("llama3_8b_decode_b4_W2048_mxint", 2048, 8, 4, 128, 16, bf16, mx,
             depths),
            ("llama3_8b_decode_b4_W2048_float", 2048, 8, 4, 128, 16, bf16, fl,
             depths),
            ("ragged_W300_mxint", 300, 8, 4, 128, 16, bf16, mx, ragged),
            ("ragged_W300_float", 300, 8, 4, 128, 16, bf16, fl, ragged),
            # a served batch: prompts of 37-1000 tokens plus 24 new ones
            ("llama3_8b_decode_b4_W2048_served_mxint", 2048, 8, 4, 128, 16,
             bf16, mx, ((0, 61), (0, 300), (0, 700), (0, 1024))),
            # a wrapped window ring with a hole, a ring with a wide hole, a
            # window in mid-ring, one valid slot past the first tile
            ("ragged_W1024_wrapped_hole_mxint", 1024, 8, 4, 128, 16, bf16, mx,
             ((300, 1024, 500, 520), (0, 1024, 100, 356), (700, 900),
              (128, 129))),
            ("ragged_W700_g1_d64_b32_mxint", 700, 8, 1, 64, 32, bf16, mx,
             ((0, 37), (0, 400), (0, 513), (0, 700))),
            ("ragged_W700_g8_d64_b4_mxint", 700, 4, 8, 64, 4, bf16, mx,
             ((0, 37), (0, 400), (0, 513), (0, 700))),
            # D 100 is not whole 16-byte chunks: element-wise tile loads
            ("ragged_W333_g3_d100_mxint", 333, 8, 3, 100, 16, bf16, mx,
             ((0, 37), (0, 200), (0, 256), (0, 333))),
            ("ragged_W1024_mxint_f32", 1024, 8, 4, 128, 16, f32, mx,
             ((0, 37), (0, 129), (0, 700), (0, 1024))),
            # the served rings of Qwen3-14B (G 5) and Phi-4-mini (G 3):
            # prompts of 37-700 tokens plus 16 new ones
            ("qwen3_14b_decode_b4_W2048_served_mxint", 2048, 8, 5, 128, 16,
             bf16, mx, ((0, 53), (0, 316), (0, 500), (0, 716))),
            ("phi4_mini_decode_b4_W2048_served_mxint", 2048, 8, 3, 128, 16,
             bf16, mx, ((0, 53), (0, 316), (0, 500), (0, 716))),
            # MXInt6 and MXInt12 scores and probabilities
            ("mant6_W700_g5_mxint", 700, 8, 5, 128, 16, bf16, mx6,
             ((0, 37), (0, 400), (0, 513), (0, 700))),
            ("mant12_W700_g3_mxint", 700, 8, 3, 128, 16, bf16, mx12,
             ((0, 37), (0, 400), (0, 513), (0, 700))),
            # RecurrentGemma-2B: head dim 256, 10 query heads over one KV
            # head; its served rings (prompts of 64-512 tokens plus 16 new
            # ones), rings of 64 and 512 slots, a wrapped window ring
            # (every slot live) beside rows short of it, both dtypes; head
            # dim 160 takes part of the second half of the columns
            ("recurrentgemma_decode_b4_W2048_served_mxint", 2048, 1, 10,
             256, 16, bf16, mx, ((0, 80), (0, 144), (0, 272), (0, 528))),
            ("recurrentgemma_decode_b4_W2048_served_mxint_f32", 2048, 1, 10,
             256, 16, f32, mx, ((0, 80), (0, 144), (0, 272), (0, 528))),
            ("recurrentgemma_decode_b4_W2048_wrapped_mxint", 2048, 1, 10,
             256, 16, bf16, mx, ((0, 2048), (0, 1500), (0, 37),
                                 (0, 2048, 900, 1100))),
            ("recurrentgemma_decode_b4_W2048_wrapped_mxint_f32", 2048, 1, 10,
             256, 16, f32, mx, ((0, 2048), (0, 1500), (0, 37),
                                (0, 2048, 900, 1100))),
            ("recurrentgemma_decode_b4_W512_mxint", 512, 1, 10, 256, 16,
             bf16, mx, ((0, 37), (0, 129), (0, 300), (0, 512))),
            ("recurrentgemma_decode_b4_W512_mxint_f32", 512, 1, 10, 256, 16,
             f32, mx, ((0, 37), (0, 129), (0, 300), (0, 512))),
            ("recurrentgemma_decode_b4_W64_mxint", 64, 1, 10, 256, 16, bf16,
             mx, ((0, 1), (0, 17), (0, 40), (0, 64))),
            ("recurrentgemma_decode_b4_W64_mxint_f32", 64, 1, 10, 256, 16,
             f32, mx, ((0, 1), (0, 17), (0, 40), (0, 64))),
            ("recurrentgemma_decode_b4_W2048_float", 2048, 1, 10, 256, 16,
             bf16, fl, ((0, 80), (0, 144), (0, 272), (0, 528))),
            ("ragged_W300_g10_d160_mxint", 300, 1, 10, 160, 16, bf16, mx,
             ragged),
            ("ragged_W300_g10_d160_mxint_f32", 300, 1, 10, 160, 16, f32, mx,
             ragged),
            # LLaVA's served ring: 4096 slots, G 4, rows of 3072 prompt
            # positions and up to 16 new tokens; SeamlessM4T's self-
            # attention ring, G 1 over 16 heads at head dim 64, every row
            # at one (scalar) index
            ("llava_decode_b4_W4096_served_mxint", VLM_MAX_LEN, 8, 4, 128,
             16, bf16, mx, ((0, 3073), (0, 3078), (0, 3083), (0, 3088))),
            ("seamless_decode_b4_W512_g1_d64_mxint", ENCDEC_MAX_LEN, 16, 1,
             64, 16, bf16, mx, ((0, 24),) * 4)):
        q = x(4, hkv, g, d, scale=1.5).to(dt)
        k = x(4, W, hkv, d, scale=1.5).to(dt)
        v = x(4, W, hkv, d).to(dt)
        valid = torch.zeros(4, W, dtype=torch.int32, device=dev)
        for i, (lo, hi, *hole) in enumerate(rows):
            valid[i, lo:hi] = 1
            if hole:
                valid[i, hole[0]:hole[1]] = 0
        n_valid = int(valid.sum())
        pairs = n_valid * hkv * g
        size = q.element_size()
        lib = None
        if label in TIMED_CASES or (W == LM_MAX_LEN and kw is fl):
            mask = (valid != 0)[:, None, None, :]

            def lib(q=q, k=k, v=v, mask=mask, hkv=hkv, g=g, d=d):
                return F.scaled_dot_product_attention(
                    q.reshape(4, hkv * g, 1, d), k.transpose(1, 2),
                    v.transpose(1, 2), attn_mask=mask, enable_gqa=True)
        cases["flash_attention_decode"].append((
            label,
            lambda q=q, k=k, v=v, valid=valid, b=blk, kw=kw:
                fa.flash_attention_decode(q, k, v, valid, act_block=b, **kw),
            lambda q=q, k=k, v=v, valid=valid, b=blk, d=d, kw=kw:
                fa.decode_rows(q, k, v, valid, r_bits=2, act_block=b,
                               scale=fa.f32(d ** -0.5),
                               **{"mant_bits": 8, **kw}).to(q.dtype),
            bound(n_valid * hkv * d * 2 * size + 2 * q.numel() * size
                  + valid.numel() * 4,
                  bf16_ops=4.0 * pairs * d if dt == bf16 else 0.0,
                  f32_ops=ROW_OPS["flash"] * pairs
                  + (4.0 * pairs * d if dt == f32 else 0.0)),
            lib))
    # (label, S, causal, window, query heads, kv_groups, head dim, act
    # block, dtype, kw)
    for label, S, causal, window, h, g, d, blk, dt, kw in (
            ("llama3_8b_score_1024_causal_mxint", 1024, True, 0, 32, 4, 128,
             16, bf16, mx),
            ("llama3_8b_score_1024_causal_float", 1024, True, 0, 32, 4, 128,
             16, bf16, fl),
            ("ragged_650_window256_mxint", 650, True, 256, 32, 4, 128, 16,
             bf16, mx),
            ("ragged_650_window256_float", 650, True, 256, 32, 4, 128, 16,
             bf16, fl),
            ("ragged_300_full_d64_g2_b32_mxint", 300, False, 0, 32, 2, 64, 32,
             bf16, mx),
            ("ragged_200_window100_d32_g8_b4_mxint", 200, True, 100, 32, 8,
             32, 4, bf16, mx),
            # group counts that do not divide 128: blocks of 42 and 25
            # positions (Phi-4-mini 24 / 8 heads, Qwen3-14B 40 / 8)
            ("phi4_mini_g3_650_causal_mxint", 650, True, 0, 24, 3, 128, 16,
             bf16, mx),
            ("phi4_mini_g3_300_full_float", 300, False, 0, 24, 3, 128, 16,
             bf16, fl),
            ("qwen3_14b_g5_650_causal_mxint", 650, True, 0, 40, 5, 128, 16,
             bf16, mx),
            ("qwen3_14b_g5_300_full_float", 300, False, 0, 40, 5, 128, 16,
             bf16, fl),
            # MXInt6 and MXInt12 scores and probabilities
            ("qwen3_14b_g5_650_causal_mant6", 650, True, 0, 40, 5, 128, 16,
             bf16, mx6),
            ("phi4_mini_g3_650_causal_mant12", 650, True, 0, 24, 3, 128, 16,
             bf16, mx12),
            # float32 operands take the ordered kernel: bit for bit
            ("ragged_650_window256_mxint_f32", 650, True, 256, 32, 4, 128, 16,
             f32, mx),
            # RecurrentGemma-2B's 1024-token score: head dim 256, 10 query
            # heads over one KV head, local window 2048 (two warps a row
            # group in the bf16 kernel, the 256-column layout in the
            # ordered one); a window inside the sequence, 12-bit scores
            # (P split in three), float, head dims 160 and 192
            ("recurrentgemma_score_1024_causal_mxint", 1024, True, 2048, 10,
             10, 256, 16, bf16, mx),
            ("recurrentgemma_score_1024_causal_float", 1024, True, 2048, 10,
             10, 256, 16, bf16, fl),
            ("recurrentgemma_score_1024_causal_mxint_f32", 1024, True, 2048,
             10, 10, 256, 16, f32, mx),
            ("ragged_650_window256_d256_g10_mxint", 650, True, 256, 10, 10,
             256, 16, bf16, mx),
            ("ragged_650_window256_d256_g10_mxint_f32", 650, True, 256, 10,
             10, 256, 16, f32, mx),
            ("recurrentgemma_g10_650_causal_mant12", 650, True, 0, 10, 10,
             256, 16, bf16, mx12),
            ("ragged_300_full_d192_g2_b32_mxint", 300, False, 0, 8, 2, 192,
             32, bf16, mx),
            ("ragged_200_window100_d160_g4_b4_mxint", 200, True, 100, 8, 4,
             160, 4, bf16, mx),
            ("ragged_300_full_d160_g4_float", 300, False, 0, 8, 4, 160, 16,
             bf16, fl),
            # SeamlessM4T's encoder over 1024 frames: non-causal, 16 heads
            # over 16 at head dim 64, the batch of 4 as 64 heads; LLaVA's
            # 3072-position score, causal, 32 heads over 8
            ("seamless_encoder_1024_full_d64_mxint", ENCDEC_FRAMES, False,
             0, LM_BATCH * 16, 1, 64, 16, bf16, mx),
            ("llava_score_3072_causal_mxint", 3072, True, 0, 32, 4, 128, 16,
             bf16, mx)):
        hkv = h // g
        q = x(h, S, d, scale=1.5).to(dt)
        k = x(hkv, S, d, scale=1.5).to(dt)
        v = x(hkv, S, d).to(dt)
        pairs = h * flash_pairs(S, S, causal, window)
        size = q.element_size()
        ops = 4.0 * pairs * d
        lib = None
        if (kw is fl and causal or label in TIMED_CASES) and \
                (window == 0 or window >= S):
            def lib(q=q, k=k, v=v, c=causal):
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=c,
                    enable_gqa=True)
        cases["flash_attention"].append((
            label,
            lambda q=q, k=k, v=v, c=causal, w=window, g=g, b=blk, kw=kw:
                fa.flash_attention(q, k, v, causal=c, window=w, kv_groups=g,
                                   act_block=b, **kw),
            lambda q=q, k=k, v=v, c=causal, w=window, g=g, b=blk, kw=kw:
                fa.flash_rows(q, k, v, causal=c, window=w, kv_groups=g,
                              r_bits=2, act_block=b,
                              scale=fa.f32(q.shape[-1] ** -0.5),
                              **{"mant_bits": 8, **kw}).to(q.dtype),
            bound(size * (2 * q.numel() + k.numel() + v.numel()),
                  bf16_ops=ops if dt == bf16 else 0.0,
                  f32_ops=ROW_OPS["flash"] * pairs
                  + (ops if dt == f32 else 0.0)),
            lib, FLASH_TOL[(dt == bf16, kw["quantize_scores"])]))
    return cases


def ln_linear_op_ops(torch, np):
    """Device operations of one ``mxint_ln_linear_op`` call as a bf16
    Llama-3-8B decode step makes it (RMSNorm -> ``wq``, 4 x 4096 -> 4096):
    the kernel and the output's cast to bf16, no conversion or fill
    before the kernel.  Raises if there are more."""
    from repro_torch.core.mx_types import MXINT8_WEIGHT
    from repro_torch.core.quantize import pack_weight
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 5)
    x = torch.from_numpy(rng.normal(size=(LM_BATCH, 1, 4096)).astype(
        np.float32)).to(DEVICE, torch.bfloat16)
    g = (1.0 + 0.1 * torch.from_numpy(rng.normal(size=4096).astype(
        np.float32))).to(DEVICE, torch.bfloat16)
    w = pack_weight(torch.from_numpy((rng.normal(size=(4096, 4096)) /
                                      64.0).astype(np.float32)).to(DEVICE),
                    MXINT8_WEIGHT)
    n, names = device_ops(lambda: ops.mxint_ln_linear_op(
        x, g, None, w.mantissa, w.exponent, w_block=w.block_size,
        rms_only=True))
    log(f"[kernel] mxint_ln_linear_op bf16 decode call: {n!r} device ops "
        f"per call {names}")
    if n is not None and n > 2:
        raise AssertionError(f"mxint_ln_linear_op ran {n} device ops a call, "
                             "more than the kernel and the output cast")
    return n


def matmul_width_check(torch):
    """``mxint_matmul`` on the card at ``act_mant_bits`` 10, 17 and 24 and
    at act block 12 on planes of 48-blocks: each computes (10 bits and act
    block 12 on the GEMM core, the others on the generic route) equal to
    its plain version; 25 bits raise before anything launches (no route
    takes them, nor does the reference's ``MXFormat``).  The GEMM core's C
    entry, called directly, still returns cudaErrorInvalidValue at 17 bits
    (its act tile holds int16 at most) and on int32 planes, and launches
    at 10 and 8.  A kernel-mode linear on 10-bit weights (int16 planes)
    computes, on the GEMM core.  Raises otherwise."""
    from repro_torch.core.mx_types import MXINT8_WEIGHT, MXFormat, QuantConfig
    from repro_torch.core.quantize import pack_weight
    from repro_torch.kernels import _build
    from repro_torch.kernels import mxint_matmul as mm
    from repro_torch.models.model_api import Param
    M, K, N = 16, 256, 128
    a = torch.ones(M, K, device=DEVICE)
    w = pack_weight(torch.ones(K, N, device=DEVICE) / 16, MXINT8_WEIGHT)
    a12 = torch.ones(M, 192, device=DEVICE)
    w12 = pack_weight(torch.ones(192, N, device=DEVICE) / 16, MXFormat(8, 48))
    routes = {}
    for key, (xa, wa, kw) in (
            ("act_mant_bits=10", (a, w, {"act_mant_bits": 10})),
            ("act_mant_bits=17", (a, w, {"act_mant_bits": 17})),
            ("act_mant_bits=24", (a, w, {"act_mant_bits": 24})),
            ("act_block=12", (a12, w12, {"act_block": 12}))):
        before = mm.generic_launches
        got = mm.mxint_matmul(xa, wa.mantissa, wa.exponent,
                              w_block=wa.block_size, quantize_act=True, **kw)
        want = mm.matmul_blocks(xa, wa.mantissa, wa.exponent,
                                w_block=wa.block_size,
                                **{"act_block": 16, "act_mant_bits": 8,
                                   **kw})
        if not bool((got == want).all()):
            raise AssertionError(f"mxint_matmul at {key} differs from its "
                                 f"plain version")
        routes[key] = "generic" if mm.generic_launches > before else "core"
    if routes != {"act_mant_bits=10": "core", "act_mant_bits=17": "generic",
                  "act_mant_bits=24": "generic", "act_block=12": "core"}:
        raise AssertionError(f"mxint_matmul routes {routes}")
    torch.cuda.synchronize()
    before = read_counts()
    msgs = {}
    try:
        mm.mxint_matmul(a, w.mantissa, w.exponent, w_block=w.block_size,
                        act_mant_bits=25, quantize_act=True)
    except ValueError as e:
        msgs["act_mant_bits=25"] = str(e)
    else:
        raise AssertionError("mxint_matmul took act_mant_bits=25")
    torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError("mxint_matmul launched outside its domain")
    out = torch.zeros(M, N, device=DEVICE)
    rcs = {}
    for key, bits, w_bytes in (("17", 17, 1), ("int32", 8, 4), ("10", 10, 1),
                               ("8", 8, 1)):
        geom = mm.gemm_geometry(M, N, K, mm.sm_count(a.device),
                                wide=bits > 8)
        rcs[key] = mm.matmul_entry()(
            *mm.launch_args(a, w.mantissa, w.exponent, out), M, K, N,
            w.block_size, bits, 16, *geom.args(), geom.kc, w_bytes,
            _build.stream_ptr(a.device))
        torch.cuda.synchronize()
    q = QuantConfig(mode="kernel", weight_fmt=MXFormat(10, 256))
    wq = Param(torch.ones(K, N, device=DEVICE) / 16, ("embed", "mlp"))
    before, gen = mm.launches, mm.generic_launches
    y = q.datapath.linear(a, wq, q=q)
    if not bool(torch.isfinite(y).all()) or mm.generic_launches != gen or \
            mm.launches != before + 1:
        raise AssertionError("a kernel-mode linear on 10-bit weights did not "
                             "take the GEMM core")
    log(f"[kernel] mxint_matmul act widths: routes {routes}, each equal to "
        f"the plain version; wrapper raised {msgs!r}; core C entry returned "
        f"{rcs['17']} at 17 bits, {rcs['int32']} on int32 planes, "
        f"{rcs['10']} at 10, {rcs['8']} at 8; a kernel-mode linear on "
        f"10-bit weights took the GEMM core")
    if rcs["17"] == 0 or rcs["int32"] == 0 or rcs["10"] != 0 or rcs["8"] != 0:
        raise AssertionError(f"mxint_matmul_launch returned {rcs}")
    return {"routes": routes, "wrapper_errors": msgs, "c_entry_rc": rcs}


def within_bf16_ulp(torch, got, want):
    """(share of the elements of ``got`` within one bf16 ulp of ``want``'s,
    the ulp no less than ``ULP_FLOOR`` of the output scale max |want|;
    largest |got - want| over that scale)."""
    g, w = got.float(), want.float()
    scale = w.abs().max()
    _, e = torch.frexp(w)
    # |w| in [2^(e-1), 2^e): 8 significant bits, so the ulp is 2^(e-8)
    ulp = torch.clamp(torch.pow(2.0, (e - 8).float()),
                      min=float(scale) * ULP_FLOOR)
    diff = (g - w).abs()
    out = diff > ulp
    rows = out.reshape(-1, out.shape[-1]).any(-1)
    log(f"[kernel]   beyond one ulp: {int(out.sum())} elements in "
        f"{int(rows.sum())} of {rows.numel()} rows"
        + (f", largest |want| among them {float(w.abs()[out].max() / scale)!r}"
           f" of scale, largest gap {float(diff[out].max() / scale)!r}"
           if bool(out.any()) else ""))
    return (float((~out).float().mean()), float(diff.max() / scale))


# the kernels over the GEMM core (a case that is not ``/generic`` must
# launch the core once)
GEMM_KERNELS = ("mxint_matmul", "mxint_ln_matmul")


def kernel_phase(torch, np, only=None):
    """Every kernel case (``kernel_cases``) held to its plain version and
    timed; a name ``<kernel>/generic`` is that kernel's generic route.
    ``only``: kernel names (a kernel's name selects its generic route
    too)."""
    results = {}
    for name, cases in kernel_cases(torch, np).items():
        base = name.split("/")[0]
        if only and name not in only and base not in only:
            continue
        res = {"name": name, "route": "cuda", "source": SOURCES[base],
               "replaces": REPLACES[base], "max_abs_err": 0.0, "cases": []}
        for i, (label, kern, plain, (b_ms, b_by), lib, *tol) in \
                enumerate(cases):
            tol = tol[0] if tol else None
            # the case's route: a ``/generic`` case launches its kernel's
            # generic route once, any other case never; a GEMM kernel's
            # other cases launch its GEMM core once
            route = f"{base}/generic"
            before = read_routes().get(route, 0)
            before_all = read_counts()[base]
            got = kern()
            torch.cuda.synchronize()
            took = read_routes().get(route, 0) - before
            if took != (1 if name == route else 0):
                raise AssertionError(f"{name} {label}: {took} launches of "
                                     f"the generic route")
            core = read_counts()[base] - before_all - took
            if base in GEMM_KERNELS and name == base and core != 1:
                raise AssertionError(f"{name} {label}: {core} launches of "
                                     f"the GEMM core")
            want = plain()
            mism = int((got != want).sum())
            err = float((got.float() - want.float()).abs().max())
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {label}: non-finite output")
            case = {"label": label, "mismatches": mism, "max_abs_err": err,
                    "route": "generic" if took else
                    "core" if base in GEMM_KERNELS else "fast"}
            log(f"[kernel] {name} {label} shape={tuple(got.shape)} "
                f"dtype={got.dtype} mismatches={mism} max_abs_err={err!r} "
                f"route={case['route']}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if tol is None:
                if mism:
                    raise AssertionError(
                        f"{name} {label}: {mism} elements differ from the "
                        f"plain version (tolerance 0)")
            else:
                share, gap = within_bf16_ulp(torch, got, want)
                case.update(within_one_bf16_ulp=share, max_gap_over_scale=gap,
                            tolerance={"within_one_bf16_ulp": tol[0],
                                       "max_gap_over_scale": tol[1]})
                log(f"[kernel] {name} {label} within one bf16 ulp: "
                    f"{share!r} (limit {tol[0]}), max gap / scale {gap!r} "
                    f"(limit {tol[1]})")
                if share < tol[0] or (tol[1] is not None and gap > tol[1]):
                    raise AssertionError(
                        f"{name} {label}: outside its tolerance {tol}")
            if i == 0 or label in TIMED_CASES:   # the path's shapes
                case["ms"] = time_ms(kern, iters=20)
                case["plain_ms"] = time_ms(plain, iters=3, warmup=1)
                case["library_ms"] = (time_ms(lib, iters=20)
                                      if lib is not None else None)
                case["bound_ms"], case["bound_by"] = b_ms, b_by
                case["device_ms"] = device_ms(kern)
                case["library_device_ms"] = (device_ms(lib)
                                             if lib is not None else None)
                for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "device_ms"):
                    if i == 0:
                        res[k] = case[k]
                log(f"[kernel] {name} {label} ms={case['ms']!r} "
                    f"plain_ms={case['plain_ms']!r} bound_ms={b_ms!r} "
                    f"({b_by}) library_ms={case['library_ms']!r} "
                    f"device_ms={case['device_ms']!r} library_device_ms="
                    f"{case['library_device_ms']!r}")
            elif lib is not None and res["library_ms"] is None:
                # a float variant's library call, where case 0 has none
                case["library_ms"] = time_ms(lib, iters=20)
                case["library_device_ms"] = device_ms(lib)
                res["library_ms"] = case["library_ms"]
                res["library_case"] = label
                log(f"[kernel] {name} {label} library_ms="
                    f"{case['library_ms']!r} library_device_ms="
                    f"{case['library_device_ms']!r}")
            res["cases"].append(case)
        if name == "mxint_ln_matmul":
            res["ln_linear_op_device_ops"] = ln_linear_op_ops(torch, np)
        if name == "mxint_matmul":
            res["act_width_check"] = matmul_width_check(torch)
        results[name] = res
        log(json.dumps({"kernel": name, "max_abs_err": res["max_abs_err"],
                        "mismatches": sum(c["mismatches"]
                                          for c in res["cases"]),
                        **{k: res[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}}))
    return results


FIXTURE_REPLACES = "src/repro/analysis/fixtures.py:43"
FIXTURE_SOURCE = "src/repro_torch/kernels/csrc/launch_fixture.cu"
FIXTURE_SENTINEL = 1234.5


def analysis_phase(torch, np):
    """The static checks on the card (``repro_torch.analysis``): the card's
    launch limits equal the contracts' constants; the launch fixture (the
    port of the reference's ``_capture_2d``): its legal launch taken and
    its output untouched, as its plain version leaves it, and each illegal
    one refused by the runtime; every record of the launch sweep against
    the C host code's own grid, threads and dynamic shared memory (each C
    entry's dry run) and the static shared memory the card reports, with
    each kernel function's registers and occupancy; a dry run armed on
    this thread leaving a launch from another thread alone; then the whole
    registry with its trace targets on the card, whose launch counters
    must equal the kernel calls (and whose real launch records must meet
    the contracts and cover their outputs).  Returns the
    launch fixture's ``kernels`` entry (its launches: the fixture launches
    of this phase's main path) and the phase's record."""
    import repro_torch.analysis as AN
    from repro_torch.analysis import fixtures as FX
    from repro_torch.analysis import launch_contracts as LC
    from repro_torch.kernels import launch_fixture as LF
    out = {}
    attrs = LF.device_attrs()
    log(f"[analysis] device attributes {json.dumps(attrs)}")
    wrong = {k: (attrs[k], v) for k, v in LC.DEVICE_LIMITS.items()
             if attrs[k] != v}
    if wrong:
        raise AssertionError(f"the card's launch limits differ from the "
                             f"contracts' constants (card, constant): "
                             f"{wrong}")
    out["device_attrs"] = attrs
    # row 8: the legal launch leaves its output as the plain version does
    rec = LF.launch_config(FX.SHAPE, FX.BLOCK, threads=256, smem=64 * 1024)
    got = torch.full(FX.SHAPE, FIXTURE_SENTINEL, device=DEVICE)
    want = LF.noop_rows(got.clone())
    rc = LF.launch_fixture(got, rec)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    log(f"[analysis] launch_fixture legal launch grid {rec.grid[:2]} "
        f"threads {rec.threads} smem {rec.smem_dynamic}: rc {rc}, "
        f"{mism} elements changed")
    if rc != (0, 0) or mism:
        raise AssertionError(f"launch_fixture: legal launch rc {rc}, "
                             f"{mism} elements changed")
    refused = {}
    for name, (shape, block, kw) in FX.REFUSED_ON_CARD.items():
        try:
            recs = LF._launch_2d(shape, block, device=DEVICE, **kw)
        except RuntimeError as e:
            refused[name] = str(e)
            log(f"[analysis] {name}: refused by the runtime: {e}")
            continue
        raise AssertionError(f"{name}: the runtime took {recs}")
    torch.cuda.synchronize()
    out["refused"] = refused
    # the C host code against the Python mirrors, record by record
    funcs, mism = {}, []
    cases = LC.sweep_cases()
    for label, kernel, kw in cases:
        r = LC.launch(kernel, kw, label)
        c = LC.query_record(kernel, kw, r)
        if (c["grid_x"], c["grid_y"], c["grid_z"]) != r.grid or \
                c["threads"] != r.threads or \
                c["smem_dynamic"] != r.smem_dynamic or \
                c["smem_static"] != r.smem_static:
            mism.append((label, kernel, c, r.grid, r.threads,
                         r.smem_dynamic))
        bad = LC.check_record(r, smem_static=c["smem_static"])
        if bad:
            mism.append((label, kernel, [str(v) for v in bad]))
        f = funcs.setdefault(r.function, {
            "kernel": kernel, "registers": c["registers"],
            "smem_static": c["smem_static"], "python_static": r.smem_static,
            "threads": r.threads, "smem_dynamic": r.smem_dynamic,
            "ctas_per_sm": c["ctas_per_sm"], "assumed_per_sm": r.per_sm,
            "records": 0})
        f["records"] += 1
    log(f"[analysis] mirrors: {len(cases)} sweep records, "
        f"{len(cases) - len(mism)} equal to the C host code (grid, threads, "
        f"dynamic shared memory) and to the card's static shared memory")
    for fn, f in sorted(funcs.items()):
        log(f"[analysis] occupancy {fn}: {f['registers']} registers a "
            f"thread, static smem {f['smem_static']} (python "
            f"{f['python_static']}), {f['threads']} threads, dynamic smem "
            f"{f['smem_dynamic']}: {f['ctas_per_sm']} CTAs an SM (the "
            f"geometry assumes {f['assumed_per_sm']})")
    if mism:
        raise AssertionError(f"launch records against the C host code: "
                             f"{mism[:5]} ({len(mism)} in all)")
    out["mirrors"] = len(cases)
    out["functions"] = funcs
    # a dry run armed on this thread leaves another thread's launch alone:
    # the GELU kernel launched from a second thread meanwhile writes its
    # output, bit for bit the plain version's
    import threading

    from repro_torch.kernels import mxint_gelu as MG
    from repro_torch.kernels.mxint_layernorm import lut_tensor
    xg = 2.0 * torch.randn(64, 768, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    table, domain = MG.gelu_table("gelu", 5, 3.0)
    want_g = MG.gelu_rows(xg, lut_tensor(table, xg.device), act_block=16,
                          mant_bits=8, domain=domain)
    other = {}
    with LF.armed("mxint_gelu") as armed:
        th = threading.Thread(target=lambda: other.update(
            y=MG.mxint_gelu(xg)))
        th.start()
        th.join()
        untouched = list(armed) == [0] * 8
    torch.cuda.synchronize()
    same = "y" in other and torch.equal(other["y"], want_g)
    log(f"[analysis] dry run armed on the main thread: a GELU launch from "
        f"another thread equal to the plain version {same}, the armed "
        f"query untouched {untouched}")
    if not (same and untouched):
        raise AssertionError("a dry run armed on one thread changed a "
                             "launch from another")
    # the main path: the fixture's legal launches and the registry on the
    # card, from counts set to 0
    from repro_torch.analysis import grid_coverage as GC
    reset_counts()
    t = time.perf_counter()
    with LC.record_launches() as real:
        for shape, block, kw in FIXTURE_LEGAL:
            LF._launch_2d(shape, block, device=DEVICE, **kw)
        # the documents beside the code are no part of the program, and a
        # copy of the program need not carry them: their rule
        # (docs-links) reads no device and is held by the CPU tests
        found = AN.run_rules(ROOT, device="cuda", skip=CARD_SKIPS)
        torch.cuda.synchronize()
    launches = read_counts()
    # the records of the real launches, at their operands' own alignment
    found += LC.check_records(real) + GC.check_records(real)
    errors = [str(v) for v in found if v.severity == AN.ERROR]
    log(f"[analysis] registry on the card: {len(AN.rules())} rules, "
        f"{len(errors)} errors, {time.perf_counter() - t!r} s; "
        f"{len(real)} launch records of real launches checked; launches "
        f"{json.dumps(launches)}")
    if errors:
        raise AssertionError(f"the static checks on the card: {errors}")
    out["launches"] = launches
    res = {"name": "launch_fixture", "route": "cuda",
           "source": FIXTURE_SOURCE, "replaces": FIXTURE_REPLACES,
           "max_abs_err": float((got - want).abs().max()),
           "ms": time_ms(lambda: LF.launch_fixture(got, rec), iters=50),
           "plain_ms": time_ms(lambda: LF.noop_rows(got), iters=50),
           # it moves no byte and does no operation
           "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None,
           "device_ms": device_ms(lambda: LF.launch_fixture(got, rec))}
    log(f"[analysis] launch_fixture one empty launch: ms {res['ms']!r} "
        f"(CUDA events), device_ms {res['device_ms']!r}, plain_ms "
        f"{res['plain_ms']!r}")
    return res, out


# the rules that the card run of the registry leaves to the CPU tests
CARD_SKIPS = ("docs-links",)

# the launch fixture's legal geometries, each at a limit, that the
# analysis phase's path launches
FIXTURE_LEGAL = (((64, 256), (16, 64), {}),
                 ((64, 256), (16, 64), {"smem": 232448, "threads": 1024}),
                 ((16, 65535), (16, 1), {}))


def kernel_breakdown(torch, run, names):
    """ms of one ``run()`` spent in each kernel op, from CUDA events
    recorded around every call (the host work between the two events is
    inside).  The name "experts" stands for the MoE expert products
    (``moe._expert_mm``: the stack's dequantize and its einsum), the names
    of ``REC_SCANS`` for the recurrent scans of ``models/recurrent.py``
    (the linears they launch inside)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe, recurrent
    where = {n: (moe, "_expert_mm") if n == "experts" else
             (recurrent, n) if n in REC_SCANS else (ops, n) for n in names}
    saved = {n: getattr(*where[n]) for n in names}
    events = {n: [] for n in names}

    def timed(name, fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events[name].append((start, end))
            return out
        return call

    try:
        for n in names:
            setattr(*where[n], timed(n, saved[n]))
        run()
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(*where[n], saved[n])
    return {n: sum(s.elapsed_time(e) for s, e in ev)
            for n, ev in events.items()}


def deit_requests(np):
    """The 5 requests of 1-16 images of the DeiT phases, and one full
    batch of their first images."""
    rng = np.random.default_rng(SEED + 1)
    sizes = [int(s) for s in rng.integers(1, BATCH + 1, size=5)]
    images = [rng.normal(size=(n, 224, 224, 3)).astype(np.float32)
              for n in sizes]
    full = np.concatenate(images)[:BATCH]
    full = np.concatenate([full, np.zeros((BATCH - len(full),) + full.shape[1:],
                                          np.float32)])
    return sizes, images, full


def conserved(tag):
    """Raise unless the scheduler telemetry's submitted == completed +
    in_flight (a step boundary's invariant)."""
    from repro_torch import telemetry as T
    snap = T.snapshot()
    sub = snap["counters"].get("scheduler/submitted", 0)
    comp = snap["counters"].get("scheduler/completed", 0)
    fly = snap["gauges"].get("scheduler/in_flight", 0)
    if sub != comp + fly:
        raise AssertionError(f"{tag}: submitted {sub} != completed {comp} + "
                             f"in flight {fly}")


def launch_samples():
    """(count, sum) of the ``scheduler/kernel_launches`` histogram."""
    from repro_torch import telemetry as T
    h = T.snapshot()["histograms"].get("scheduler/kernel_launches")
    return (0, 0.0) if h is None else (h["count"], h["sum"])


def check_launch_counters(tag, launches):
    """Raise unless the ``kernel/launches/<kernel>`` counters equal the
    kernels' own counts over the same run."""
    from repro_torch import telemetry as T
    counters = T.snapshot()["counters"]
    from repro_torch.kernels import ops
    launches = {n: launches[n] for n in ops.SERVED_KERNELS}
    got = {n: counters.get(f"kernel/launches/{n}") for n in launches}
    if got != launches:
        raise AssertionError(f"{tag}: telemetry counted launches {got}, the "
                             f"kernels {launches}")


def telemetry_report(tag):
    """The default registry's snapshot, with its JSON and Prometheus text
    sizes logged."""
    from repro_torch import telemetry as T
    from repro_torch.telemetry.export import json_snapshot, prometheus_text
    snap = json_snapshot()
    log(f"[{tag} telemetry] snapshot {len(json.dumps(snap))} bytes of JSON, "
        f"{len(prometheus_text(snap))} bytes of Prometheus text; "
        f"{len(snap['counters'])} counters, {len(snap['gauges'])} gauges, "
        f"{len(snap['histograms'])} histograms")
    return snap


def serve_deit(torch, np, engine, sizes, images, tag, per_batch):
    """Serve the requests through ``ClassifyScheduler`` after a warm
    batch, the telemetry registry reset and the launch counts set to 0
    just before; returns (batches, seconds, launches, telemetry).  Raises
    unless every request finished in order with finite logits of its
    shape, submitted == completed + in_flight after every step, each
    step's ``scheduler/kernel_launches`` sample equals the kernels' own
    counts of that step and ``per_batch`` (kernel -> launches a batch),
    and the ``scheduler/classify_step`` span's mean agrees with CUDA events
    around the same steps' forwards within 5% or 0.5 ms (the span is
    device-true)."""
    from repro_torch import telemetry as T
    from repro_torch.serving.scheduler import ClassifyRequest, ClassifyScheduler
    engine.logits_batch(np.zeros((BATCH, 224, 224, 3), np.float32))  # warm
    torch.cuda.synchronize()
    T.reset()
    sched = ClassifyScheduler(engine)
    for uid, imgs in enumerate(images):
        sched.submit(ClassifyRequest(uid, imgs))
        conserved(tag)
    events = []
    forward = engine.logits_batch

    def timed_forward(chunk):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(chunk)
        end.record()
        events.append((start, end))
        return out

    engine.logits_batch = timed_forward
    reset_counts()
    want = sum(per_batch.values())
    t0 = time.perf_counter()
    n_batches = 0
    try:
        while True:
            before, samples = read_counts(), launch_samples()
            n = sched.step()
            conserved(tag)
            step = sum(count_diff(read_counts(), before).values())
            new = launch_samples()
            if not n:
                break
            n_batches += 1
            if new != (samples[0] + 1, samples[1] + step) or step != want:
                raise AssertionError(
                    f"{tag}: step {n_batches} launched {step} kernels (want "
                    f"{want}); kernel_launches went {samples} -> {new}")
    finally:
        del engine.logits_batch
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    check_launch_counters(tag, launches)
    ev_ms = [s.elapsed_time(e) for s, e in events]
    n_span, span_ms = T.span_stats("scheduler/classify_step")
    ev_mean = statistics.mean(ev_ms)
    log(f"[{tag}] request sizes={sizes} batches={n_batches} "
        f"serve_s={serve_s!r} launches={launches}; classify_step span mean "
        f"{span_ms!r} ms over {n_span} steps, CUDA events {ev_mean!r} ms "
        f"({ev_ms})")
    if n_span != n_batches or len(ev_ms) != n_batches or \
            abs(span_ms - ev_mean) > max(0.05 * ev_mean, 0.5):
        raise AssertionError(f"{tag}: the classify_step span ({span_ms} ms) "
                             f"and CUDA events ({ev_mean} ms) disagree")
    done = sched.finished
    if [r.uid for r in done] != list(range(len(sizes))):
        raise AssertionError(f"{tag}: requests did not all finish in order")
    for r, n in zip(done, sizes):
        if r.logits.shape != (n, 1000) or r.labels.shape != (n,) or \
                not np.isfinite(r.logits).all():
            raise AssertionError(f"{tag}: request {r.uid}: bad result shapes")
    snap = T.snapshot()
    if snap["counters"]["scheduler/images_classified"] != sum(sizes) or \
            snap["counters"]["scheduler/completed"] != len(sizes):
        raise AssertionError(f"{tag}: telemetry lost images or requests")
    return n_batches, serve_s, launches, {
        "classify_step_span_ms": span_ms, "classify_step_events_ms": ev_mean,
        "snapshot": telemetry_report(tag)}


def attention_products_ms(torch, cfg):
    """The whole-row attention's q.kT and P.V products at one layer's
    shape of ``cfg`` (a ViT) at batch ``BATCH``: (BATCH x heads) rows of
    (tokens x head dim) operands, in float64 rounded once to float32, as
    ``ops._paper_softmax_attention`` computes them, and as two float32
    ``torch.matmul`` calls (full float32, no TF32): ms by CUDA events
    (casts included) and device ms from a trace, one layer and one batch
    of ``cfg.n_layers`` layers; part of the DeiT phase's "other"."""
    n = (cfg.image_size // cfg.patch_size) ** 2 + 1
    hd = cfg.d_model // cfg.n_heads
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    q, k, v = (torch.randn(BATCH * cfg.n_heads, n, hd, device=DEVICE,
                           generator=g) for _ in range(3))
    p = torch.softmax(torch.randn(BATCH * cfg.n_heads, n, n, device=DEVICE,
                                  generator=g), -1)

    def f64():
        torch.matmul(q.double(), k.double().transpose(1, 2)).float()
        torch.matmul(p.double(), v.double()).float()

    def f32():
        torch.matmul(q, k.transpose(1, 2))
        torch.matmul(p, v)

    res = {"rows": BATCH * cfg.n_heads, "tokens": n, "head_dim": hd}
    for name, fn in (("float64", f64), ("float32", f32)):
        ms, dev = time_ms(fn, iters=20), device_ms(fn, iters=10)
        res[name] = {"ms_per_layer": ms, "device_ms_per_layer": dev,
                     "ms_per_batch": ms * cfg.n_layers,
                     "device_ms_per_batch": None if dev is None else
                     dev * cfg.n_layers}
    log(f"[slice] whole-row attention products, {res['rows']} rows of "
        f"{n} x {hd} a layer: float64 (the port) "
        f"{res['float64']['ms_per_layer']!r} ms / "
        f"{res['float64']['device_ms_per_layer']!r} device, float32 "
        f"{res['float32']['ms_per_layer']!r} / "
        f"{res['float32']['device_ms_per_layer']!r}; a batch of "
        f"{cfg.n_layers} layers {res['float64']['ms_per_batch']!r} against "
        f"{res['float32']['ms_per_batch']!r} ms")
    return res


def slice_phase(torch, np):
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import (ServeConfig, ViTServingEngine,
                                            params_to)

    L = DEIT_BASE.n_layers
    per_forward = {"mxint_matmul": 2 * L + 2, "mxint_ln_matmul": 4 * L,
                   "mxint_softmax": L, "mxint_gelu": L, "mxint_layernorm": 1,
                   "flash_attention": 0, "flash_attention_decode": 0,
                   "launch_fixture": 0}
    assert sum(per_forward.values()) == 3 + 8 * L

    cfg = dataclasses.replace(
        DEIT_BASE, quant=QuantConfig(mode="kernel", quantize_nonlinear=True))
    model = ViT(cfg)
    params = model.init(SEED, device=DEVICE)
    engine = ViTServingEngine(model, params,
                              ServeConfig(batch=BATCH, pack_weights=True),
                              device=DEVICE)
    sizes, images, full = deit_requests(np)
    n_batches, serve_s, launches, telemetry = serve_deit(
        torch, np, engine, sizes, images, "slice", per_forward)
    want = {n: c * n_batches for n, c in per_forward.items()}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if sum(launches.values()) != (3 + 8 * L) * n_batches:
        raise AssertionError(f"launch total is not {3 + 8 * L} per batch")

    ms_batch = time_ms(lambda: engine.logits_batch(full), iters=5)
    n_images = sum(sizes)
    stats = {"request_sizes": sizes, "batches": n_batches,
             "images": n_images, "serve_s": serve_s,
             "serve_images_per_s": n_images / serve_s,
             "ms_per_batch": ms_batch,
             "images_per_s": BATCH / (ms_batch / 1e3), "launches": launches,
             "telemetry": telemetry}
    busy = device_ms(lambda: engine.logits_batch(full), iters=5,
                     cats=BUSY_CATS)
    stats.update(device_busy_ms_per_batch=busy,
                 device_idle_share=idle_share(busy, ms_batch))
    log(f"[slice] ms_per_batch={ms_batch!r} (batch {BATCH}) "
        f"images_per_s={stats['images_per_s']!r} device busy {busy!r} ms "
        f"(kernels, copies), idle share {stats['device_idle_share']!r}")
    per_kernel = kernel_breakdown(torch, lambda: engine.logits_batch(full), [
        n for n, c in per_forward.items() if c])
    stats["kernel_ms_per_batch"] = per_kernel
    stats["other_ms_per_batch"] = ms_batch - sum(per_kernel.values())
    log(f"[slice] device ms per batch by kernel {per_kernel}, other "
        f"(attention products, glue, gaps) {stats['other_ms_per_batch']!r}")
    stats["attention_products"] = attention_products_ms(torch, cfg)

    # the same model on the CPU through the plain versions
    imgs4 = np.concatenate(images)[:4]
    _, gpu = engine.classify(imgs4)
    gpu = gpu.cpu().numpy()
    cpu_engine = ViTServingEngine(model, params_to(params, "cpu"),
                                  ServeConfig(batch=4, pack_weights=True),
                                  device="cpu")
    t0 = time.perf_counter()
    _, ref = cpu_engine.classify(imgs4)
    ref = ref.numpy()
    gap = float(np.abs(gpu - ref).max())
    scale = float(np.abs(ref).max())
    agree = bool((gpu.argmax(-1) == ref.argmax(-1)).all())
    stats.update(cpu_ref_s=time.perf_counter() - t0, cpu_gap=gap,
                 cpu_logit_scale=scale, argmax_agree=agree)
    log(f"[slice] cpu reference: max_abs_gap={gap!r} scale={scale!r} "
        f"argmax_agree={agree}")
    if not agree or gap > 1e-3 * scale:
        raise AssertionError("card and CPU logits disagree beyond 1e-3 of "
                             "their scale or in argmax")
    return stats, launches


# the "tp" phase: DeiT-Base at full width and depth (MXInt6 planes, MXInt8
# acts, batch BATCH) served sharded over TP_RANKS ranks that share the one
# card (gloo on cuda:0), against the single-process engine; TP_STREAM is
# the scheduler's mixed stream (7 requests of 1-8 images); TP_TIMED
# batches timed per engine; TP_CPU_LAYERS layers of the row strategy held
# card against CPU; POD_STEPS "off" steps of DeiT-Base at POD_BATCH
# images a pod over a ("pod",) mesh of TP_RANKS with grad_compression,
# and DeiT-Micro's POD_MICRO_STEPS card against CPU
TP_RANKS = 2
TP_STREAM = (3, 5, 1, 8, 2, 7, 4)
TP_TIMED = 5
TP_CPU_LAYERS = 2
POD_BATCH = 16
POD_STEPS = 2
POD_MICRO_BATCH = 8
POD_MICRO_STEPS = 2


def tp_tasks(cfg, params, imgs, cfg2, params2, micro, micro_params,
             micro_batch, full: bool, pod=None):
    """The rank-side tasks of the tp phase (``sharded_check.run_tasks``):
    with ``full``, DeiT-Base column (with the stream), row and data-only
    serving, timed, and the DeiT-Base pod steps (``pod`` = (config,
    params, batch)); always the row strategy at ``TP_CPU_LAYERS`` layers
    and DeiT-Micro's pod steps, the parts the CPU ranks repeat."""
    tp = ((TP_RANKS,), ("model",), None)
    dp = ((TP_RANKS, 1), ("data", "model"), None)
    pods = ((TP_RANKS,), ("pod",), None)
    common = dict(cfg=cfg, params=params, imgs=imgs, batch=BATCH)
    tasks = []
    if full:
        tasks += [("serve", tp, dict(common, strategy="column",
                                     stream=TP_STREAM, timed=TP_TIMED)),
                  ("serve", tp, dict(common, strategy="row", timed=TP_TIMED)),
                  ("serve", dp, dict(common, strategy="column",
                                     timed=TP_TIMED)),
                  ("pod_step", pods, dict(cfg=pod[0], params=pod[1],
                                          batch=pod[2], steps=POD_STEPS,
                                          lr=TRAIN_LR, keep_params=False))]
    tasks += [("serve", tp, dict(cfg=cfg2, params=params2, imgs=imgs,
                                 batch=BATCH, strategy="row")),
              ("pod_step", pods, dict(cfg=micro, params=micro_params,
                                      batch=micro_batch,
                                      steps=POD_MICRO_STEPS, lr=TRAIN_LR))]
    return tasks


def tp_cpu_side(tasks):
    """The tp phase's CPU side: the same tasks on ``TP_RANKS`` gloo CPU
    ranks (one torch thread each)."""
    from repro_torch.parallel.spawn import spawn
    from repro_torch.serving import sharded_check as SC
    t0 = time.perf_counter()
    ranks = spawn(SC.run_tasks, TP_RANKS, (tasks,), device="cpu",
                  threads=CPU_THREADS)
    return ranks, time.perf_counter() - t0


def tp_phase(torch, np, smi):
    """Tensor- and data-parallel MXInt serving of DeiT-Base on
    ``TP_RANKS`` ranks sharing the one card (``parallel.spawn``: gloo on
    cuda:0, the kernels built here first), and the pod-axis compressed
    gradient path.  Column sharding and the data axis (a ("data", "model")
    mesh of (2, 1)) must equal the single-process engine bit for bit; the
    row strategy is held to the single-process engine on its own planes
    (``pack_params_mxint(tp_shards=2)``) within ``sharded_check.ROW_TOL``
    of the scale with argmax equal, its gap to the default planes logged;
    the scheduler's stream must classify every request, every step's
    per-rank launches equal to ``vit_launches``, each forward's launches
    and collectives likewise.
    Timings: ms a batch on each rank beside the card's name and power
    limit; two ranks share one card, so none of it is a scaling number.
    The pod steps: ms and peak GiB per rank, the residuals nonzero after
    every step.  The card-against-CPU part (the row strategy at
    ``TP_CPU_LAYERS`` layers bit for bit, DeiT-Micro's pod steps within
    ``LM_SMOKE_LOSS_TOL``) is queued on ``CPU_CHECKS``; returns (stats,
    the function that compares, the column stream's launches on rank 0 as
    its kernels' counters read them around each scheduler step)."""
    from repro_torch.configs.deit import DEIT_BASE, DEIT_MICRO
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.models.launches import vit_launches
    from repro_torch.models.vit import ViT
    from repro_torch.parallel.spawn import spawn
    from repro_torch.serving import sharded_check as SC
    from repro_torch.serving.engine import pack_params_mxint

    kernel = QuantConfig(mode="kernel", quantize_nonlinear=True)
    cfg = dataclasses.replace(DEIT_BASE, quant=kernel)
    cfg2 = dataclasses.replace(cfg, n_layers=TP_CPU_LAYERS)
    params = ViT(cfg).init(SEED, device=DEVICE)
    params2 = ViT(cfg2).init(SEED + 1, device=DEVICE)
    imgs = SC.images(BATCH, cfg.image_size, SEED + 20)
    want = SC.single_device_logits(cfg, params, imgs, BATCH, DEVICE)
    want_row = SC.single_device_logits(
        cfg, pack_params_mxint(params, cfg.quant.weight_fmt,
                               tp_shards=TP_RANKS), imgs, BATCH, DEVICE)
    from repro_torch.serving.engine import params_to
    params, params2 = params_to(params, "cpu"), params_to(params2, "cpu")
    torch.cuda.empty_cache()
    off = dataclasses.replace(DEIT_BASE, quant=QuantConfig())
    rng = np.random.default_rng(SEED + 21)
    pod_batch = {"images": rng.normal(size=(
        TP_RANKS * POD_BATCH, 224, 224, 3)).astype(np.float32),
        "labels": rng.integers(0, off.n_classes, size=(
            TP_RANKS * POD_BATCH,)).astype(np.int32)}
    pod_params = ViT(off).init(SEED + 2, device="cpu")
    micro = DEIT_MICRO
    micro_params = ViT(micro).init(SEED + 3, device="cpu")
    micro_batch = {"images": rng.normal(size=(
        TP_RANKS * POD_MICRO_BATCH, 32, 32, 3)).astype(np.float32),
        "labels": rng.integers(0, micro.n_classes, size=(
            TP_RANKS * POD_MICRO_BATCH,)).astype(np.int32)}
    small = (cfg2, params2, micro, micro_params, micro_batch)
    t0 = time.perf_counter()
    ranks = spawn(SC.run_tasks, TP_RANKS, (tp_tasks(
        cfg, params, imgs, *small, full=True,
        pod=(off, pod_params, pod_batch)),), device="cuda")
    spawn_s = time.perf_counter() - t0
    col, row, dp, pod, row2, micro_card = (
        [r[i] for r in ranks] for i in range(6))
    stats = {"card": smi, "ranks": TP_RANKS, "spawn_s": spawn_s,
             "note": "two ranks share one card: no time here is a scaling "
                     "number"}
    stats["column"] = SC.compare(col[0]["logits"], want)
    stats["data"] = SC.compare(dp[0]["logits"], want)
    stats["row"] = SC.compare(row[0]["logits"], want_row)
    stats["row_vs_default_planes"] = SC.compare(row[0]["logits"], want)
    for name, rs in (("column", col), ("row", row), ("data", dp)):
        stats[name].update(
            ms_per_batch=[r["ms_per_batch"] for r in rs],
            peak_gib=[r.get("peak_gib") for r in rs],
            launches_per_forward=[r["launches_per_forward"] for r in rs],
            collectives_per_forward=[r["collectives_per_forward"]
                                     for r in rs])
        parity = {k: stats[name][k] for k in ("bit_exact", "max_abs_diff",
                                               "scale", "argmax_equal")}
        log(f"[tp {name}] {smi}: ms a batch of {BATCH} per rank "
            f"{stats[name]['ms_per_batch']}, peak GiB per rank "
            f"{stats[name]['peak_gib']}, collectives a forward "
            f"{stats[name]['collectives_per_forward'][0]}; against the "
            f"single process: {json.dumps(parity)}")
    log(f"[tp row] against the default planes: "
        f"{json.dumps(stats['row_vs_default_planes'])}")
    for name in ("column", "data"):
        if not stats[name]["bit_exact"]:
            raise AssertionError(f"tp {name}: the sharded logits differ "
                                 f"from the single process's")
    r = stats["row"]
    if not r["argmax_equal"] or r["max_abs_diff"] > SC.ROW_TOL * r["scale"]:
        raise AssertionError("tp row: beyond ROW_TOL of the single process "
                             "on the same planes, or argmax")
    for name, rs, dp_ in (("column", col, 1), ("row", row, 1),
                          ("data", dp, TP_RANKS)):
        tp_ = 1 if name == "data" else TP_RANKS
        want_l = vit_launches(cfg, "column" if name == "data" else name, tp_)
        for rk, res in enumerate(rs):
            if res["launches_per_forward"] != want_l or \
                    res["calls_per_forward"] != want_l:
                raise AssertionError(
                    f"tp {name} rank {rk}: launches a forward "
                    f"{res['launches_per_forward']} != {want_l}")
    stream = col[0]["stream"]
    per_step = vit_launches(cfg)
    stats["stream"] = {k: v for k, v in stream.items()
                       if k not in ("calls_per_step", "launches_per_step")}
    stats["stream"]["steps"] = len(stream["launches_per_step"])
    log(f"[tp stream] {json.dumps(stats['stream'])}")
    for rk, res in enumerate(col):
        s = res["stream"]
        if not s["all_classified"] or s["requests"] != len(TP_STREAM):
            raise AssertionError(f"tp stream rank {rk}: not every request "
                                 f"was classified")
        if any(c != per_step for c in s["launches_per_step"]) or \
                any(c != per_step for c in s["calls_per_step"]):
            raise AssertionError(f"tp stream rank {rk}: a step's launches "
                                 f"are not {per_step}")
    stats["pod"] = {"config": "deit_base", "mode": "off",
                    "batch_per_pod": POD_BATCH, "steps": POD_STEPS,
                    "ranks": [{k: r.get(k) for k in ("metrics", "peak_gib",
                                                     "err_nonzero", "pod")}
                              for r in pod]}
    log(f"[tp pod] {smi}: DeiT-Base off, {POD_BATCH} images a pod, "
        f"grad_compression over ('pod',) of {TP_RANKS}: "
        f"{json.dumps(stats['pod']['ranks'])}")
    if not all(m["err_nonzero"] for r in pod for m in r["metrics"]):
        raise AssertionError("tp pod: a pod's residuals are zero after a "
                             "step")
    if len({r["metrics"][-1]["loss"] for r in pod}) != 1:
        raise AssertionError("tp pod: the pods' mean losses differ")
    job = CPU_CHECKS.add("tp cpu", tp_cpu_side, tp_tasks(
        cfg, params, imgs, *small, full=False))
    # rank 0's launches in the stream, read from its kernels' counters
    launches = {k: sum(c[k] for c in stream["launches_per_step"])
                for k in per_step}

    def finish():
        cpu_ranks, cpu_s = CPU_CHECKS.result(job)
        row_cpu = cpu_ranks[0][0]["logits"]
        res = SC.compare(row2[0]["logits"], row_cpu)
        res["differing_elements"] = int((row2[0]["logits"] != row_cpu).sum())
        log(f"[tp cpu] row strategy, {TP_CPU_LAYERS} layers, card against "
            f"{TP_RANKS} CPU ranks: {json.dumps(res)} (cpu {cpu_s!r} s)")
        if not res["bit_exact"]:
            raise AssertionError("tp cpu: the row strategy's logits differ "
                                 "card against CPU")
        card_l = [m["loss"] for m in micro_card[0]["metrics"]]
        cpu_l = [m["loss"] for m in cpu_ranks[0][1]["metrics"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        par = max(float(np.abs(a - b).max()) for a, b in zip(
            micro_card[0]["params"], cpu_ranks[0][1]["params"]))
        pod_res = {"loss_card": card_l, "loss_cpu": cpu_l,
                   "max_loss_gap_rel": rel, "max_param_gap": par,
                   "tolerance": LM_SMOKE_LOSS_TOL}
        log(f"[tp cpu] DeiT-Micro pod steps card against CPU: "
            f"{json.dumps(pod_res)}")
        if rel > LM_SMOKE_LOSS_TOL:
            raise AssertionError("tp cpu: the micro pod steps' losses differ "
                                 "card against CPU beyond LM_SMOKE_LOSS_TOL")
        return {"row": res, "pod_micro": pod_res, "cpu_s": cpu_s}

    return stats, finish, launches


def quant_config(mode, kw):
    """A ``QuantConfig``; kw's "overrides" names a glob whose layer groups
    run "sim"."""
    from repro_torch.core.mx_types import QuantConfig, QuantOverride
    kw = dict(kw)
    pattern = kw.pop("overrides", None)
    if pattern:
        kw["overrides"] = ((pattern, QuantOverride(mode="sim")),)
    return QuantConfig(mode=mode, **kw)


def card_against_cpu(torch, np, model, params_cpu, images, packed, tag):
    """(max gap, logit scale, differing elements, argmax equal) of
    ``images`` through the model on the card and on the CPU."""
    from repro_torch.serving.engine import (ServeConfig, ViTServingEngine,
                                            params_to)
    out = {}
    for dev in (DEVICE, "cpu"):
        eng = ViTServingEngine(model, params_to(params_cpu, dev), ServeConfig(
            batch=len(images), pack_weights=packed), device=dev)
        out[dev] = eng.classify(images)[1].float().cpu().numpy()
        del eng
    gpu, ref = out[DEVICE], out["cpu"]
    gap, scale = float(np.abs(gpu - ref).max()), float(np.abs(ref).max())
    differ = int((gpu != ref).sum())
    agree = bool((gpu.argmax(-1) == ref.argmax(-1)).all())
    log(f"[{tag}] card against cpu: max_abs_gap={gap!r} scale={scale!r} "
        f"differing elements {differ} of {gpu.size}, argmax_agree={agree}")
    if not agree or gap > 1e-3 * scale:
        raise AssertionError(f"{tag}: card and CPU logits disagree beyond "
                             f"1e-3 of their scale or in argmax")
    return gap, scale, differ, agree


def backends_phase(torch, np):
    """DeiT-Base at full width and depth in the four non-kernel modes and
    the kernel/sim-FFN mixed configuration (module docstring, item 7)."""
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import ServeConfig, ViTServingEngine

    L = DEIT_BASE.n_layers
    mixed_per_forward = {"mxint_matmul": L + 2, "mxint_ln_matmul": 3 * L,
                         "mxint_softmax": L, "mxint_gelu": 0,
                         "mxint_layernorm": 1, "flash_attention": 0,
                         "flash_attention_decode": 0,
                         "launch_fixture": 0}
    assert sum(mixed_per_forward.values()) == 3 + 5 * L
    sizes, images, full = deit_requests(np)
    imgs4 = np.concatenate(images)[:4]
    params = ViT(DEIT_BASE).init(SEED, device=DEVICE)     # the DeiT phase's
    small = ViT(dataclasses.replace(DEIT_BASE, n_layers=2)).init(
        SEED, device="cpu")
    kernel = ViTServingEngine(
        ViT(dataclasses.replace(DEIT_BASE, quant=quant_config(
            "kernel", {"quantize_nonlinear": True}))), params,
        ServeConfig(batch=BATCH, pack_weights=True), device=DEVICE)
    kernel_logits = kernel.logits_batch(full).float().cpu()
    del kernel
    results, mixed_launches = {}, None
    for label, (mode, kw, packed) in BACKENDS.items():
        tag = f"backends {label}"
        cfg = dataclasses.replace(DEIT_BASE, quant=quant_config(mode, kw))
        engine = ViTServingEngine(ViT(cfg), params, ServeConfig(
            batch=BATCH, pack_weights=packed), device=DEVICE)
        per_forward = (mixed_per_forward if label == "mixed"
                       else dict.fromkeys(mixed_per_forward, 0))
        n_batches, serve_s, launches, telemetry = serve_deit(
            torch, np, engine, sizes, images, tag, per_forward)
        want = {n: c * n_batches for n, c in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches} != {want}")
        if label == "mixed":
            mixed_launches = launches
        ms = time_ms(lambda: engine.logits_batch(full), iters=5)
        busy = device_ms(lambda: engine.logits_batch(full), iters=3,
                         cats=BUSY_CATS)
        res = {"mode": mode, "config": cfg.quant.describe(),
               "overrides": kw.get("overrides"), "packed_planes": packed,
               "batches": n_batches, "serve_s": serve_s,
               "launches": launches,
               "launches_per_forward": sum(per_forward.values()),
               "classify_step_span_ms": telemetry["classify_step_span_ms"],
               "classify_step_events_ms":
                   telemetry["classify_step_events_ms"],
               "ms_per_batch": ms, "images_per_s": BATCH / (ms / 1e3),
               "device_busy_ms_per_batch": busy,
               "device_idle_share": idle_share(busy, ms)}
        log(f"[{tag}] ms_per_batch={ms!r} (batch {BATCH}) images_per_s="
            f"{res['images_per_s']!r} device busy {busy!r} ms, idle share "
            f"{res['device_idle_share']!r}; launches per forward "
            f"{res['launches_per_forward']}")
        if label == "sim":
            logits = engine.logits_batch(full).float().cpu()
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{tag}: non-finite logits")
            scale = float(kernel_logits.abs().max())
            gap = float((logits - kernel_logits).abs().max()) / scale
            agree = float((logits.argmax(-1) == kernel_logits.argmax(-1))
                          .float().mean())
            res.update(sim_vs_kernel_max_gap_over_scale=gap,
                       sim_vs_kernel_argmax_agreement=agree,
                       sim_vs_kernel_tolerance=SIM_KERNEL_TOL)
            log(f"[{tag}] against the all-kernel model, {L} layers, "
                f"{BATCH} images: max gap / scale {gap!r} (limit "
                f"{SIM_KERNEL_TOL['max_gap_over_scale']}), argmax agreement "
                f"{agree!r} (limit {SIM_KERNEL_TOL['argmax_agreement']})")
            if gap > SIM_KERNEL_TOL["max_gap_over_scale"] or \
                    agree < SIM_KERNEL_TOL["argmax_agreement"]:
                raise AssertionError(f"{tag}: sim and kernel logits differ "
                                     f"beyond {SIM_KERNEL_TOL}")
        del engine
        gap, scale, differ, agree = card_against_cpu(
            torch, np, ViT(dataclasses.replace(cfg, n_layers=2)), small,
            imgs4, packed, tag)
        res.update(cpu_gap=gap, cpu_logit_scale=scale,
                   cpu_differing_elements=differ, argmax_agree=agree)
        results[label] = res
    return results, mixed_launches


def cut_depth(cfg, units: int):
    """``cfg`` cut to ``units`` repeats of its unit and no tail (a dense
    stack: ``units`` layers)."""
    return dataclasses.replace(cfg, n_units=units, tail=(),
                               n_layers=units * len(cfg.unit))


def lm_serve_phase(torch, np, full, prompts, new_tokens, tag):
    """A dense LM at full size (``full``) through ServingEngine and
    BatchScheduler(batch_size=LM_BATCH), the
    telemetry registry reset at its start: every slot prefill and decode
    step timed and its launches checked against ``lm_launches``,
    submitted == completed + in_flight after every scheduler step, and
    each step's ``scheduler/kernel_launches`` samples equal to the
    kernels' own counts of its calls.  Then one decode step split by
    kernel (and, for a MoE model, the expert products beside their byte
    bounds), its device busy time, and the unembedding's time a step."""
    from repro_torch import telemetry as T
    from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import BatchScheduler, Request

    cfg = dataclasses.replace(
        full, quant=QuantConfig(mode="kernel", quantize_nonlinear=True))
    L = cfg.n_layers
    moe = cfg.ffn_kind == "moe"
    model = DecoderLM(cfg)
    free, total = torch.cuda.mem_get_info()
    log(f"[{tag}] before the weights: {free / 2 ** 30!r} GiB free of "
        f"{total / 2 ** 30!r}, {torch.cuda.memory_allocated() / 2 ** 30!r} "
        f"allocated")
    t0 = time.perf_counter()
    params = model.init(SEED, device=DEVICE, pack_fmt=MXINT8_WEIGHT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, ServeConfig(
        max_len=LM_MAX_LEN, batch=LM_BATCH, pack_weights=True,
        weight_fmt=MXINT8_WEIGHT), device=DEVICE)
    allocated = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[{tag}] {cfg.name} {L} layers ({' '.join(cfg.layer_kinds)}), "
        f"d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, d_ff {cfg.d_ff}"
        + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}" if moe
           else "") + f", vocab {cfg.vocab}, "
        f"packed on the card in {init_s!r} s, {allocated!r} GiB allocated")
    # warm up both steps on a scratch cache (cuBLAS handles, allocator)
    scratch = model.cache_init(LM_BATCH, LM_MAX_LEN, DEVICE)
    tok, scratch = engine._prefill_slot(
        engine.params, torch.zeros(1, 64, dtype=torch.int32, device=DEVICE),
        37, 0, scratch)
    engine._decode(engine.params, torch.zeros(LM_BATCH, 1, dtype=torch.int32,
                                              device=DEVICE), scratch)
    del scratch
    torch.cuda.synchronize()

    calls = []
    prefill, decode = engine._prefill_slot, engine._decode

    def timed(kind, fn):
        def call(*a, **k):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            calls.append((kind, int(a[1].shape[1]) if kind == "prefill"
                          else None, ms, count_diff(read_counts(), before)))
            return out
        return call

    engine._prefill_slot = timed("prefill", prefill)
    engine._decode = timed("decode", decode)
    rng = np.random.default_rng(SEED + 2)
    T.reset()
    sched = BatchScheduler(engine, batch_size=LM_BATCH)
    for uid, n in enumerate(prompts):
        sched.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, size=n).astype(np.int32),
            max_new_tokens=new_tokens))
        conserved(tag)
    reset_counts()
    t0 = time.perf_counter()
    while True:
        seen, samples = len(calls), launch_samples()
        live = sched.step()
        conserved(tag)
        step = [sum(c[3].values()) for c in calls[seen:]]
        new = launch_samples()
        if new != (samples[0] + len(step), samples[1] + sum(step)):
            raise AssertionError(f"{tag}: calls launched {step}; "
                                 f"kernel_launches went {samples} -> {new}")
        if live == 0 and not sched.queue:
            break
    done = sched.run()
    conserved(tag)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    engine._prefill_slot, engine._decode = prefill, decode
    check_launch_counters(tag, launches)

    if sorted(r.uid for r in done) != list(range(len(prompts))):
        raise AssertionError(f"{tag}: requests did not all finish")
    for r in done:
        if len(r.generated) != new_tokens or \
                not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"{tag}: request {r.uid}: {r.generated}")
    pre = [c for c in calls if c[0] == "prefill"]
    dec = [c for c in calls if c[0] == "decode"]
    totals = []
    for kind, P, _, got in calls:
        want = lm_launches(cfg, P or 1, decode=kind == "decode")
        if got != want:
            raise AssertionError(f"{tag}: {kind} launched {got}, expected "
                                 f"{want}")
        totals.append(sum(want.values()))
    per_step = sum(lm_launches(cfg, 1, decode=True).values())
    per_prefill = sum(lm_launches(cfg, 64).values())
    snap = T.snapshot()
    h = snap["histograms"]["scheduler/kernel_launches"]
    if (h["min"], h["max"], h["count"]) != (min(totals), max(totals),
                                            len(calls)):
        raise AssertionError(f"{tag}: kernel_launches samples {h}")
    if snap["counters"]["scheduler/completed"] != len(prompts) or \
            snap["counters"]["scheduler/tokens_generated"] != \
            len(prompts) * (new_tokens - 1):
        raise AssertionError(f"{tag}: telemetry lost requests or tokens")
    by_bucket = {}
    for _, P, ms, _ in pre:
        by_bucket.setdefault(P, []).append(ms)
    dec_ms = [ms for *_, ms, _ in dec]
    step_ms = statistics.median(dec_ms)
    n_span, span_ms = T.span_stats("scheduler/decode_step")
    stats = {"model": cfg.name, "layers": L, "init_s": init_s,
             "gib_allocated": allocated, "prompts": list(prompts),
             "new_tokens": new_tokens, "batch": LM_BATCH,
             "max_len": LM_MAX_LEN, "serve_s": serve_s,
             "prefill_ms_by_bucket": by_bucket, "decode_steps": len(dec),
             "decode_ms": dec_ms, "decode_ms_median": step_ms,
             "decode_tokens_per_s": LM_BATCH / (step_ms / 1e3),
             "decode_step_span_ms_mean": span_ms,
             "launches_per_decode_step": per_step,
             "launches_per_slot_prefill": per_prefill,
             "launches_per_call_range": [min(totals), max(totals)],
             "launches": launches,
             "tokens": {r.uid: r.generated for r in done},
             "telemetry": telemetry_report(tag)}
    # one decode step split by kernel (rows at four depths of the ring)
    names = [n for n, c in lm_launches(cfg, 1, decode=True).items() if c] + (
        ["experts"] if moe else [])
    cache = model.cache_init(LM_BATCH, LM_MAX_LEN, DEVICE)
    cache["index"] = torch.tensor([37, 700, 1500, 2000], dtype=torch.int32,
                                  device=DEVICE)
    step = lambda: engine._decode(engine.params, torch.zeros(  # noqa: E731
        LM_BATCH, 1, dtype=torch.int32, device=DEVICE), cache)
    step()
    step_total = time_ms(step, iters=5)
    by_kernel = kernel_breakdown(torch, step, names)
    stats["decode_step_ms_by_kernel"] = by_kernel
    stats["decode_step_ms_other"] = step_total - sum(by_kernel.values())
    stats["decode_step_ms_events"] = step_total
    busy = device_ms(step, iters=3, cats=BUSY_CATS)
    stats.update(decode_step_device_busy_ms=busy,
                 decode_step_device_idle_share=idle_share(busy, step_total))
    if moe:
        stats["experts"] = expert_bounds(engine.params, by_kernel["experts"],
                                         tag)
    del cache
    # the unembedding of a decode step: the (vocab, d) planes dequantized
    # and one torch.matmul, every step
    h_last = torch.randn(LM_BATCH, 1, cfg.d_model, device=DEVICE).to(cfg.dtype)
    unembed = lambda: model.logits(engine.params, h_last)  # noqa: E731
    stats["unembed_ms_events"] = time_ms(unembed, iters=5)
    stats["unembed_device_ms"] = device_ms(unembed, iters=3, cats=BUSY_CATS)
    log(f"[{tag}] one decode step {step_total!r} ms by kernel {by_kernel}"
        f", other (unembedding, embedding, RoPE, glue, gaps) "
        f"{stats['decode_step_ms_other']!r}; device busy {busy!r} ms, idle "
        f"share {stats['decode_step_device_idle_share']!r}; the unembedding "
        f"({cfg.vocab} x {cfg.d_model}) {stats['unembed_ms_events']!r} ms by "
        f"events, {stats['unembed_device_ms']!r} device")
    log(f"[{tag}] {len(prompts)} requests x {new_tokens} tokens "
        f"in {serve_s!r} s; {len(pre)} slot prefills, {len(dec)} decode "
        f"steps; launches {launches}")
    log(f"[{tag}] prefill ms by bucket {by_bucket}")
    log(f"[{tag}] decode ms per step median={step_ms!r} "
        f"min={min(dec_ms)!r} max={max(dec_ms)!r}; decode_step span mean "
        f"{span_ms!r} ms over {n_span}; decode tokens/s at batch "
        f"{LM_BATCH}={stats['decode_tokens_per_s']!r}; launches per decode "
        f"step {per_step}, per 64-token slot prefill {per_prefill}, per "
        f"call {min(totals)}-{max(totals)}")
    return model, engine, stats


def expert_bounds(params, expert_ms, tag):
    """A decode step's expert products (``expert_ms`` by events) beside
    byte bounds at the card's memory rate: the MXInt planes of every
    expert stack read once; the dequantize the reference's
    ``weight_value`` does (the planes read, the bf16 stack written and
    read again by the einsum); and the passes the port makes (the planes
    read, the float32 mantissas and their float32 products each written
    and read, the float64 stack written and read by the einsum)."""
    elems = plane_bytes = 0
    for layer in params["layers"]:
        for name in ("wi", "wg", "wo"):
            w = layer["ffn"][name].value
            elems += w.mantissa.numel()
            plane_bytes += w.mantissa.numel() + w.exponent.numel()
    planes_ms, _ = bound(plane_bytes)
    dequant_ms, _ = bound(plane_bytes + 2 * 2 * elems)
    passes_ms, _ = bound(plane_bytes + (8 + 8 + 16) * elems)
    log(f"[{tag}] a decode step's expert products {expert_ms!r} ms by "
        f"events; bounds: the planes read once ({plane_bytes / 1e9!r} GB) "
        f"{planes_ms!r} ms, dequantized to bf16 and read again "
        f"{dequant_ms!r} ms, the port's passes {passes_ms!r} ms")
    return {"ms": expert_ms, "plane_bytes": plane_bytes,
            "planes_once_ms": planes_ms, "dequantize_bound_ms": dequant_ms,
            "port_passes_bound_ms": passes_ms}


def lm_score_phase(torch, np, model, engine, tag="lm score",
                   tokens=LM_SCORE_TOKENS, trace=True):
    """One full-size loss forward of ``tokens`` tokens (with a MoE
    model's load-balancing loss): at 1024 tokens the flash kernel in every
    attention layer.  ``trace``: also trace two forwards for the device's
    busy time (xLSTM's 1024-token forward issues some 10^5 device ops;
    its busy time is read from a traced prefill instead).  Scoring runs
    under ``torch.no_grad()``: ``loss`` is differentiable, and the score
    timings must not build a graph."""
    with torch.no_grad():
        return _lm_score(torch, np, model, engine, tag, tokens, trace)


def _lm_score(torch, np, model, engine, tag, n_tokens, trace):
    toks = np.random.default_rng(SEED + 3).integers(
        0, model.cfg.vocab, size=(1, n_tokens)).astype(np.int32)
    model.loss(engine.params, {"tokens": toks})           # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss = float(model.loss(engine.params, {"tokens": toks}))
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = read_counts()
    want = lm_launches(model.cfg, n_tokens, score=True)
    if launches != want:
        raise AssertionError(f"{tag}: launched {launches}, expected {want}")
    if not (0.0 < loss < 2.0 * float(np.log(model.cfg.vocab))):
        raise AssertionError(f"loss {loss} is not finite and plausible")
    stats = {"tokens": n_tokens, "loss": loss, "ms": score_s * 1e3,
             "tokens_per_s": n_tokens / score_s, "launches": launches}
    run = lambda: model.loss(engine.params, {"tokens": toks})  # noqa: E731
    stats["ms_by_kernel"] = kernel_breakdown(
        torch, run, [n for n, c in want.items() if c]
        + (["experts"] if model.cfg.ffn_kind == "moe" else []))
    busy = device_ms(run, iters=2, cats=BUSY_CATS) if trace else None
    stats.update(device_busy_ms=busy,
                 device_idle_share=idle_share(busy, stats["ms"]))
    log(f"[{tag}] ms by kernel {stats['ms_by_kernel']}; device busy "
        f"{busy!r} ms, idle share {stats['device_idle_share']!r}")
    log(f"[{tag}] {n_tokens} tokens loss={loss!r} "
        f"ms={stats['ms']!r} tokens/s={stats['tokens_per_s']!r} "
        f"launches {launches}")
    return stats, launches


# phase 6: label -> (mode, config kwargs, MXInt8 planes)
LM_CPU_MODES = {"kernel": ("kernel", {"quantize_nonlinear": True}, True),
                "off": ("off", {}, False),
                "sim": ("sim", {"quantize_nonlinear": True}, True),
                "packed": ("packed", {"quantize_nonlinear": True}, True)}


def lm_side(dev, base, label, params, prompts, scores):
    """One side of an LM card-against-CPU check in mode ``label`` (of
    ``LM_CPU_MODES``) on ``dev``: 2 requests of ``prompts`` served (4 new
    tokens each) and each of ``scores`` scored; returns (tokens by
    request, logits, seconds, launches)."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import BatchScheduler, Request

    mode, kw, _ = LM_CPU_MODES[label]
    model = DecoderLM(dataclasses.replace(base, quant=quant_config(mode, kw)))
    t0 = time.perf_counter()
    reset_counts()
    eng = ServingEngine(model, params, ServeConfig(max_len=300, batch=2),
                        device=dev)
    sched = BatchScheduler(eng, batch_size=2)
    for uid, pr in enumerate(prompts):
        sched.submit(Request(uid=uid, prompt=pr, max_new_tokens=4))
    tokens = {r.uid: r.generated for r in sched.run()}
    logits = np.concatenate([
        model.forward(eng.params, toks).float().cpu().numpy()[0]
        for toks in scores])[None]
    if dev != "cpu":
        torch.cuda.synchronize()
    return tokens, logits, time.perf_counter() - t0, read_counts()


# jobs whose float64 expert products scale with threads take more of them
CPU_JOB_THREADS = {"mixtral_8x7b cpu kernel": 4}


def lm_cpu_phase(torch, np, full, modes, prompt_lens, score_tokens, tag,
                 layers):
    """An LM architecture (``full``) at full width, ``layers`` repeats of
    its unit (``layers`` layers of a dense stack) and no tail, float32: the
    card against the CPU, serving 2 requests of ``prompt_lens`` tokens (4
    new tokens each) and scoring ``score_tokens`` tokens (a count, or a
    tuple of counts each scored), in each of ``modes`` (labels of
    ``LM_CPU_MODES``).  The card side runs here; the CPU side is queued on
    ``CPU_CHECKS``.  Returns the function that compares the two once the
    CPU sides have run."""
    base = dataclasses.replace(cut_depth(full, layers), dtype=torch.float32)
    from repro_torch.models.transformer import DecoderLM
    floats, planes = cpu_check_params(torch, DecoderLM(base))
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, base.vocab, size=n).astype(np.int32)
               for n in prompt_lens]
    if isinstance(score_tokens, int):
        score_tokens = (score_tokens,)
    scores = [rng.integers(0, base.vocab, size=(1, n)).astype(np.int32)
              for n in score_tokens]
    pending = {}
    for label in modes:
        mode, _, packed = LM_CPU_MODES[label]
        params = planes if packed else floats
        card = lm_side(DEVICE, base, label, params, prompts, scores)
        log(f"[{tag} {label}] {DEVICE}: served and scored in {card[2]!r} s")
        job = CPU_CHECKS.add(f"{tag} {label}", lm_side, "cpu", base, label,
                             params, prompts, scores)
        pending[label] = (card, job, mode)
        launches = card[3]
        log(f"[{tag} {label}] card launches {launches}")
        if mode != "kernel" and any(launches.values()):
            raise AssertionError(f"{tag} {label}: launched kernels "
                                 f"{launches}")
    del floats, planes

    def finish():
        results = {}
        for label, (card, job, mode) in pending.items():
            cpu = CPU_CHECKS.result(job)
            log(f"[{tag} {label}] cpu: served and scored in {cpu[2]!r} s "
                f"(one thread, beside the other checks)")
            res = compare_card_cpu(f"{tag} {label}", {
                DEVICE: card[:2], "cpu": cpu[:2]})
            res.update(layers=base.n_layers, score_tokens=score_tokens,
                       card_s=card[2], cpu_s=cpu[2], card_launches=card[3])
            results[label] = res
        return results

    return finish


def telemetry_step_us(iters: int = 2000) -> float:
    """Host microseconds of the telemetry one scheduler decode step
    records (its span with an attribute and the profiler annotation, the
    launch fold, a counter, the tokens/s gauge and the three occupancy
    gauges), by the host clock over ``iters`` empty steps; the registry is
    reset after."""
    from repro_torch import telemetry as T
    from repro_torch.serving.scheduler import _count_launches
    t0 = time.perf_counter()
    for _ in range(iters):
        with T.span("cost/decode_step", live=4) as sp, _count_launches():
            pass
        T.counter("cost/tokens_generated").inc(4)
        T.gauge("cost/tokens_per_s").set(4 / max(sp.elapsed_s, 1e-9))
        for g in ("queue_depth", "slots_active", "in_flight"):
            T.gauge(f"cost/{g}").set(1)
    us = (time.perf_counter() - t0) / iters * 1e6
    T.reset()
    return us


def probes_phase(smi):
    """The reference's four probe labels on the card, each timed by a
    device-true span (CUDA events); and the host cost of a scheduler
    step's telemetry."""
    from repro_torch.telemetry.export import predicted_vs_measured
    from repro_torch.telemetry.probes import PROBES, run_probes
    ms = run_probes(tuple(PROBES), repeats=10, device=DEVICE)
    join = predicted_vs_measured()          # the Hopper cost table's rows
    us = telemetry_step_us()
    log(f"[probes] {smi}: " + ", ".join(f"{k} {v!r} ms"
                                        for k, v in ms.items()))
    for k in join["kernels"]:
        log(f"[probes] predicted vs measured {k['label']}: measured "
            f"{k['measured_ms']!r} ms, predicted {k['predicted_ms']!r} ms "
            f"({k['bottleneck']}), achieved fraction "
            f"{k['achieved_fraction']!r}")
    if sorted(k["label"] for k in join["kernels"]) != sorted(PROBES) or \
            join["unmatched"]:
        raise AssertionError(f"the probes did not all join the cost table: "
                             f"{join}")
    log(f"[probes] telemetry of one scheduler step: {us!r} us of host time")
    return {"card": smi, "mean_ms": ms, "predicted_vs_measured": join,
            "telemetry_step_us": us}


def dse_spaces():
    """The DSE phase's spaces on kernel-mode DeiT-Base (MXInt8 weights of
    256-blocks, MXInt8 activations of 16-blocks, the MXInt non-linears):
    (a) the reference CLI's per-group space, ``block/*/attn`` and
    ``block/*/ffn`` at weight bits {3, 4, 6, 8}, 16 points; (b) an act space
    on every scope, act bits {6, 8, 12} x act blocks {16, 32}, 6 points."""
    from repro_torch.core.mx_types import MXFormat, QuantConfig
    from repro_torch.dse.space import GroupSpace, SearchSpace
    base = QuantConfig(mode="kernel", quantize_nonlinear=True,
                       weight_fmt=MXFormat(8, 256), act_fmt=MXFormat(8, 16))
    widths = (3, 4, 6, 8)
    per_group = SearchSpace(base=base, groups=(
        GroupSpace(scope="block/*/attn", weight_mant_bits=widths),
        GroupSpace(scope="block/*/ffn", weight_mant_bits=widths)))
    act = SearchSpace(base=base, groups=(
        GroupSpace(scope="*", act_mant_bits=(6, 8, 12),
                   act_block_size=(16, 32)),))
    return per_group, act


def dse_run(torch, ev, points, tag):
    """Evaluate ``points`` in turn, each with the launch counts set to 0
    just before and read just after; returns (results, rows, launches)."""
    from repro_torch import telemetry as T
    rows, total = [], {}
    results = []
    for p in points:
        hist = T.snapshot()["histograms"].get("span/dse/eval/ms")
        before_ms = 0.0 if hist is None else hist["sum"]
        n_before = ev.n_evaluated
        reset_counts()
        r = ev(p)
        counts = read_counts()
        fresh = ev.n_evaluated > n_before
        ms = T.snapshot()["histograms"]["span/dse/eval/ms"]["sum"] - before_ms
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        launches = sum(counts.values())
        row = {"point": {f"{s}:{k}": v for (s, k), v in sorted(p.items())},
               "accuracy": r.accuracy, "fidelity": r.fidelity,
               "weight_bits": r.cost.weight_bits,
               "act_bits": r.cost.act_bits,
               "hbm_bytes": r.cost.kernel_hbm_bytes,
               "ms_per_eval": ms, "launches_per_forward": launches}
        log(f"[dse {tag}] {row['point']} accuracy={r.accuracy!r} "
            f"fidelity={r.fidelity!r} weight_bits={r.cost.weight_bits!r} "
            f"predicted_hbm_bytes={r.cost.kernel_hbm_bytes} "
            f"ms_per_eval={ms!r} launches_per_forward={launches}")
        if not bool(torch.isfinite(ev.logits_for(p)).all()):
            raise AssertionError(f"dse {tag}: non-finite logits at {p}")
        if fresh and launches != 3 + 8 * ev.cfg.n_layers:
            raise AssertionError(f"dse {tag}: {launches} launches a kernel-"
                                 f"mode forward, not {3 + 8 * ev.cfg.n_layers}")
        results.append(r)
        rows.append(row)
    return results, rows, total


def dse_front(results, tag):
    from repro_torch.dse.report import pareto_front
    front = pareto_front(results)
    for i in front:
        r = results[i]
        log(f"[dse {tag}] pareto: {dict(sorted(r.point.items()))} accuracy="
            f"{r.accuracy!r} weight_bits={r.cost.weight_bits!r} "
            f"hbm_bytes={r.cost.kernel_hbm_bytes}")
    return front


def dse_phase(torch, np):
    """Design-space exploration in kernel mode on DeiT-Base at full width
    and depth (module docstring, item 10)."""
    from repro_torch import telemetry as T
    from repro_torch.analysis.cost_model import DEIT_BASE_LABELS
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.dse.drivers import greedy_search
    from repro_torch.dse.evaluate import Evaluator
    from repro_torch.models.vit import ViT
    per_group, act = dse_spaces()
    params = ViT(DEIT_BASE).init(SEED, device=DEVICE)
    images = SyntheticImageData(n_classes=DEIT_BASE.n_classes,
                                batch=DSE_IMAGES,
                                image_size=DEIT_BASE.image_size, seed=SEED,
                                device=DEVICE).next_batch()["images"]
    T.reset()
    ev = Evaluator(per_group, DEIT_BASE, params, images,
                   kernel_rows=DEIT_BASE_LABELS, device=DEVICE)
    ev.reference                        # the float model, once
    out, launches = {}, {}
    for tag, space, evaluator in (
            ("a", per_group, ev),
            ("b", act, Evaluator(act, DEIT_BASE, params, images,
                                 kernel_rows=DEIT_BASE_LABELS,
                                 device=DEVICE))):
        results, rows, counts = dse_run(torch, evaluator, space.points(), tag)
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        out[tag] = {"space": space.describe(), "candidates": rows,
                    "pareto": dse_front(results, tag)}
    # (c) the greedy driver at the 1% budget on space (a), through the
    # evaluator of (a): every point it visits is in its cache
    hits = T.counter("dse/cache_hits").value
    g = greedy_search(per_group, ev, budget=0.01)
    out["c"] = {"bits": g.bits, "metric": g.metric, "trace": g.trace,
                "cache_hits": T.counter("dse/cache_hits").value - hits}
    log(f"[dse c] greedy at budget 0.01: bits {g.bits}, score {g.metric!r}, "
        f"trace {g.trace}, {out['c']['cache_hits']} cache hits")
    snap = T.snapshot()
    span_ms = snap["histograms"]["span/dse/eval/ms"]
    out["evaluations"] = snap["counters"]["dse/evaluations"]
    out["ms_per_eval"] = span_ms["mean"]
    out["evals_per_s"] = 1e3 / span_ms["mean"]
    log(f"[dse] {out['evaluations']} evaluations of {DSE_IMAGES} images, "
        f"{span_ms['mean']!r} ms each (span/dse/eval, device-true), "
        f"{out['evals_per_s']!r} evaluations/s")
    del ev, params
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = dse_card_vs_cpu(torch, act, images)
    return out, launches


def dse_card_vs_cpu(torch, space, images):
    """Space (b) at 2 layers of DeiT-Base on the card and on the CPU (the
    kernels' plain versions), the same weights and images: per candidate
    the logits bit for bit, accuracy equal, fidelity within 1e-6."""
    import dataclasses as dc
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.dse.evaluate import Evaluator
    from repro_torch.models.vit import ViT
    cfg = dc.replace(DEIT_BASE, n_layers=DSE_CPU_LAYERS)
    params = ViT(cfg).init(SEED, device="cpu")
    imgs = images[:DSE_CPU_IMAGES].cpu()
    evs = {dev: Evaluator(space, cfg, params, imgs, kernel_rows=(),
                          device=dev) for dev in (DEVICE, "cpu")}
    rows = []
    for p in space.points():
        r = {dev: ev(p) for dev, ev in evs.items()}
        card = evs[DEVICE].logits_for(p).cpu()
        cpu = evs["cpu"].logits_for(p)
        differ = int((card != cpu).sum())
        row = {"point": {f"{s}:{k}": v for (s, k), v in sorted(p.items())},
               "differing_logits": differ,
               "accuracy": (r[DEVICE].accuracy, r["cpu"].accuracy),
               "fidelity_gap": abs(r[DEVICE].fidelity - r["cpu"].fidelity)}
        log(f"[dse card vs cpu] {row['point']}: {differ} differing logits of "
            f"{card.numel()}, accuracy {row['accuracy']}, fidelity gap "
            f"{row['fidelity_gap']!r}")
        if differ or r[DEVICE].accuracy != r["cpu"].accuracy or \
                row["fidelity_gap"] > 1e-6:
            raise AssertionError(f"dse card vs cpu: {row}")
        rows.append(row)
    return rows


# the served widened format (``widened_serve_phase``'s third label, its
# DeiT-Tiny card-against-CPU check): W12 planes (int16), act block 12,
# which does not nest in the 256-element weight blocks, and Table VI's
# vanilla LUTs; the GEMMs run on the GEMM core by segment, the row kernels
# on their generic routes
WIDE_WEIGHT = (12, 256)
WIDE_ACT_FMT = (8, 12)
# the widened serve's fourth label: 17-bit acts (MXFormat(17, 16)), past
# the core's int16 act tile, so every GEMM of a forward (2 L + 2 and 4 L)
# takes the generic GEMM routes: the served format that keeps them on a
# path
WIDE_GEN_ACT = (17, 16)
WIDE_NL = dict(ln_lut_bits=13, gelu_lut_bits=14, softmax_r_bits=16)
WIDE_CPU_LAYERS = 2
WIDE_CPU_IMAGES = 4
# the widened LM path: Llama-3-8B at full width, one layer, score act
# block 64 (past the fast flash kernels' 32): its decode steps and its
# 1024-token score take the flash kernels' generic routes
WIDE_LM_ACT = (8, 64)
WIDE_LM_PROMPTS = (37, 300, 700)
WIDE_LM_NEW_TOKENS = 4


def wide_quant(mode="kernel"):
    from repro_torch.core.mx_types import MXFormat, NonlinearConfig, QuantConfig
    return QuantConfig(mode=mode, quantize_nonlinear=True,
                       weight_fmt=MXFormat(*WIDE_WEIGHT),
                       act_fmt=MXFormat(*WIDE_ACT_FMT),
                       nonlinear=NonlinearConfig(**WIDE_NL))


def widened_trace(torch, engine, images, ms, tag):
    """One batch of a served widened format traced with ``torch.profiler``:
    the device's busy ms (kernels, copies, fills) and idle share against
    ``ms`` (CUDA events around a batch), and the device ms by kernel
    function (our kernels by instance: the GEMM core's variant, or the
    generic route)."""
    events = trace_events(lambda: engine.logits_batch(images), iters=1)
    busy = sum(e.get("dur", 0) for e in events) / 1e3
    by = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel":
            key = "copies and fills"
        elif "at::" in name:
            key = short_kernel_name(name)
        else:
            key = name.replace("void ", "").split("(", 1)[0]
        by[key] = by.get(key, 0.0) + e.get("dur", 0) / 1e3
    by = dict(sorted(by.items(), key=lambda kv: -kv[1]))
    out = {"ms_events": ms, "device_busy_ms": busy,
           "device_idle_share": idle_share(busy, ms),
           "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
           "device_ms_by_kernel": by}
    log(f"[{tag}] a traced batch: device busy {busy!r} ms of {ms!r} ms, idle "
        f"share {out['device_idle_share']!r}, {out['kernels']} kernels; "
        f"device ms by kernel {by}")
    return out


def widened_serve_phase(torch, np):
    """DeiT-Base at full width and depth served through
    ``ClassifyScheduler`` in kernel mode with act formats past block 16 and
    8 bits: ``QuantOverride(act_fmt=MXFormat(8, 32))`` on ``block/*/ffn``,
    ``act_fmt=MXFormat(12, 16)`` globally, the widened format
    (``wide_quant``: W12 planes, act block 12, LN 13-bit, GELU 14-bit and
    softmax r 16 LUTs), whose GEMMs run on the GEMM core by segment and
    whose row kernels (25 launches a forward) take their generic routes,
    one batch of it traced (``widened_trace``), and 17-bit acts
    (``WIDE_GEN_ACT``), whose GEMMs (74 a forward) take the generic GEMM
    routes; 3 + 8 x 12 launches a batch, kernel by kernel (and route by
    route), ms per batch by CUDA events.  Returns (results, launches,
    generic-route launches)."""
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.core.mx_types import MXFormat, QuantConfig, QuantOverride
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import ServeConfig, ViTServingEngine
    L = DEIT_BASE.n_layers
    per_forward = {"mxint_matmul": 2 * L + 2, "mxint_ln_matmul": 4 * L,
                   "mxint_softmax": L, "mxint_gelu": L, "mxint_layernorm": 1,
                   "flash_attention": 0, "flash_attention_decode": 0,
                   "launch_fixture": 0}
    # the generic-route launches a forward of each label
    row_gen = {"mxint_softmax/generic": L, "mxint_gelu/generic": L,
               "mxint_layernorm/generic": 1}
    gemm_gen = {"mxint_matmul/generic": 2 * L + 2,
                "mxint_ln_matmul/generic": 4 * L}
    sizes, images, full = deit_requests(np)
    params = ViT(DEIT_BASE).init(SEED, device=DEVICE)
    out, launches, routes = {}, {}, {}
    for label, q, wfmt, gen_fwd in (
            ("ffn_act_block_32", QuantConfig(
                mode="kernel", quantize_nonlinear=True,
                overrides=(("block/*/ffn",
                            QuantOverride(act_fmt=MXFormat(8, 32))),)), None,
             {}),
            ("act_12_bits", QuantConfig(mode="kernel",
                                        quantize_nonlinear=True,
                                        act_fmt=MXFormat(12, 16)), None, {}),
            ("w12_a12_vanilla_luts", wide_quant(), MXFormat(*WIDE_WEIGHT),
             row_gen),
            ("a17_bits", QuantConfig(mode="kernel", quantize_nonlinear=True,
                                     act_fmt=MXFormat(*WIDE_GEN_ACT)), None,
             gemm_gen)):
        tag = f"widened {label}"
        engine = ViTServingEngine(
            ViT(dataclasses.replace(DEIT_BASE, quant=q)), params,
            ServeConfig(batch=BATCH, pack_weights=True, weight_fmt=wfmt),
            device=DEVICE)
        n_batches, serve_s, got, telemetry = serve_deit(
            torch, np, engine, sizes, images, tag, per_forward)
        if got != {n: c * n_batches for n, c in per_forward.items()}:
            raise AssertionError(f"{tag}: launches {got}")
        gen = read_routes()
        want_gen = {n: gen_fwd.get(n, 0) * n_batches for n in gen}
        if gen != want_gen:
            raise AssertionError(f"{tag}: generic-route launches {gen}, "
                                 f"expected {want_gen}")
        ms = time_ms(lambda: engine.logits_batch(full), iters=5)
        logits = engine.logits_batch(full)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: non-finite logits")
        out[label] = {"config": q.describe(), "batches": n_batches,
                      "serve_s": serve_s, "launches": got,
                      "generic_launches": gen, "ms_per_batch": ms,
                      "classify_step_span_ms":
                          telemetry["classify_step_span_ms"]}
        if wfmt is not None:
            out[label]["trace"] = widened_trace(torch, engine, full, ms, tag)
        log(f"[{tag}] ms_per_batch={ms!r} (batch {BATCH}) launches {got} "
            f"generic routes {gen}")
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        for n, c in gen.items():
            routes[n] = routes.get(n, 0) + c
        del engine
    return out, launches, routes


def widened_lm_phase(torch, np):
    """Llama-3-8B at full width and one layer, kernel mode at score act
    block 64 (``WIDE_LM_ACT``): ``WIDE_LM_PROMPTS`` requests of
    ``WIDE_LM_NEW_TOKENS`` tokens through ``BatchScheduler`` (every decode
    step on the decode kernel's generic route), then a 1024-token score
    (the flash kernel's generic route); every flash and decode launch must
    take the generic route.  Returns (results, launches, generic-route
    launches)."""
    from repro_torch.configs import llama3_8b
    from repro_torch.core.mx_types import MXINT8_WEIGHT, MXFormat, QuantConfig
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import BatchScheduler, Request
    cfg = dataclasses.replace(
        cut_depth(llama3_8b.FULL, 1), quant=QuantConfig(
            mode="kernel", quantize_nonlinear=True,
            act_fmt=MXFormat(*WIDE_LM_ACT)))
    model = DecoderLM(cfg)
    params = model.init(SEED, device=DEVICE, pack_fmt=MXINT8_WEIGHT)
    engine = ServingEngine(model, params, ServeConfig(
        max_len=LM_MAX_LEN, batch=LM_BATCH, pack_weights=True,
        weight_fmt=MXINT8_WEIGHT), device=DEVICE)
    rng = np.random.default_rng(SEED + 5)
    sched = BatchScheduler(engine, batch_size=LM_BATCH)
    for uid, n in enumerate(WIDE_LM_PROMPTS):
        sched.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, size=n).astype(np.int32),
            max_new_tokens=WIDE_LM_NEW_TOKENS))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve, serve_gen = read_counts(), read_routes()
    toks = rng.integers(0, cfg.vocab, size=(1, LM_SCORE_TOKENS)).astype(
        np.int32)
    with torch.no_grad():
        reset_counts()
        t0 = time.perf_counter()
        loss = float(model.loss(engine.params, {"tokens": toks}))
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
    score, score_gen = read_counts(), read_routes()
    for r in done:
        if len(r.generated) != WIDE_LM_NEW_TOKENS or \
                not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"widened lm: request {r.uid}: "
                                 f"{r.generated}")
    if len(done) != len(WIDE_LM_PROMPTS) or \
            not (0.0 < loss < 2.0 * float(np.log(cfg.vocab))):
        raise AssertionError(f"widened lm: {len(done)} requests, loss {loss}")
    for tag, counts, gen in (("serve", serve, serve_gen),
                             ("score", score, score_gen)):
        for n in ("flash_attention", "flash_attention_decode"):
            if gen[f"{n}/generic"] != counts[n]:
                raise AssertionError(f"widened lm {tag}: {n} launched "
                                     f"{counts[n]}, generic route "
                                     f"{gen[f'{n}/generic']}")
    if not serve["flash_attention_decode"] or not score["flash_attention"]:
        raise AssertionError("widened lm: no decode step or score took the "
                             "flash kernels")
    res = {"model": cfg.name, "layers": 1, "act_fmt": list(WIDE_LM_ACT),
           "prompts": list(WIDE_LM_PROMPTS), "serve_s": serve_s,
           "score_tokens": LM_SCORE_TOKENS, "score_ms": score_s * 1e3,
           "loss": loss, "serve_launches": serve,
           "serve_generic_launches": serve_gen, "score_launches": score,
           "score_generic_launches": score_gen}
    log(f"[widened lm] {len(done)} requests x {WIDE_LM_NEW_TOKENS} tokens in "
        f"{serve_s!r} s, launches {serve}, generic routes {serve_gen}; "
        f"{LM_SCORE_TOKENS}-token score {score_s * 1e3!r} ms, loss {loss!r}, "
        f"launches {score}, generic routes {score_gen}")
    launches = {n: serve[n] + score[n] for n in serve}
    routes = {n: serve_gen[n] + score_gen[n] for n in serve_gen}
    del engine, model, params
    torch.cuda.empty_cache()
    return res, launches, routes


def widened_side(dev, cfg, params, images):
    """DeiT-Tiny at the widened format on ``dev``: (logits, generic-route
    launches of the forward, launches of the forward)."""
    import torch
    from repro_torch.core.mx_types import MXFormat
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import (ServeConfig, ViTServingEngine,
                                            params_to)
    eng = ViTServingEngine(ViT(cfg), params_to(params, dev), ServeConfig(
        batch=len(images), pack_weights=True,
        weight_fmt=MXFormat(*WIDE_WEIGHT)), device=dev)
    before, before_all = read_routes(), read_counts()
    logits = eng.classify(images)[1].float().cpu().numpy()
    if dev != "cpu":
        torch.cuda.synchronize()
    return (logits, count_diff(read_routes(), before),
            count_diff(read_counts(), before_all))


def widened_cpu_phase(torch, np):
    """DeiT-Tiny (``WIDE_CPU_LAYERS`` layers) at the widened format on the
    card and on the CPU, the same weights (drawn on the card) and images:
    logits bit for bit, the card's GEMMs on the GEMM core and its row
    kernels on their generic routes.  The CPU side is queued on
    ``CPU_CHECKS``; returns the function that compares."""
    from repro_torch.configs.deit import DEIT_TINY
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import params_to
    cfg = dataclasses.replace(DEIT_TINY, n_layers=WIDE_CPU_LAYERS,
                              quant=wide_quant())
    params = params_to(ViT(cfg).init(SEED, device=DEVICE), "cpu")
    images = np.random.default_rng(SEED + 6).normal(size=(
        WIDE_CPU_IMAGES, 224, 224, 3)).astype(np.float32)
    card, gen, counts = widened_side(DEVICE, cfg, params, images)
    L = WIDE_CPU_LAYERS
    want = {"mxint_matmul/generic": 0, "mxint_ln_matmul/generic": 0,
            "mxint_softmax/generic": L, "mxint_gelu/generic": L,
            "mxint_layernorm/generic": 1, "flash_attention/generic": 0,
            "flash_attention_decode/generic": 0}
    if gen != want or counts["mxint_matmul"] != 2 * L + 2 or \
            counts["mxint_ln_matmul"] != 4 * L:
        raise AssertionError(f"widened cpu: card launches {counts}, generic "
                             f"routes {gen}")
    job = CPU_CHECKS.add("widened cpu", widened_side, "cpu", cfg, params,
                         images)

    def finish():
        cpu, *_ = CPU_CHECKS.result(job)
        differ = int((card != cpu).sum())
        agree = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        log(f"[widened cpu] DeiT-Tiny {L} layers, {WIDE_CPU_IMAGES} images: "
            f"{differ} differing logits of {card.size}, argmax agree "
            f"{agree}")
        if differ:
            raise AssertionError("widened cpu: card and CPU logits differ")
        return {"layers": L, "images": WIDE_CPU_IMAGES,
                "differing_logits": differ, "argmax_agree": agree,
                "card_launches": counts, "card_generic_launches": gen}

    return finish


def moe_phases(torch, np, phase):
    """Each of ``MOE_LMS`` at full width and ``MOE_SERVE_LAYERS`` layers:
    served (the LM serve phase's checks, launches pinned) and one
    1024-token ``loss`` forward with the load-balancing loss (their card-
    against-CPU checks: ``card_vs_cpu_phases``).  Every earlier model is
    freed first."""
    import importlib
    torch.cuda.empty_cache()
    out = {}
    for name in MOE_LMS:
        full = importlib.import_module(f"repro_torch.configs.{name}").FULL
        model, engine, serve = phase(
            f"{name} serve", lm_serve_phase, torch, np,
            cut_depth(full, MOE_SERVE_LAYERS), NEW_LM_PROMPTS,
            NEW_LM_NEW_TOKENS, name)
        check_full_depth_launches(name, serve)
        score, _ = phase(f"{name} score", lm_score_phase, torch, np, model,
                         engine, f"{name} score")
        del model, engine
        torch.cuda.empty_cache()
        out[name] = {"serve": serve, "score": score}
    return out


def prefill_split(torch, model, engine, tag):
    """One ``REC_PREFILL_SPLIT``-token slot prefill into a scratch cache:
    ms by CUDA events around the call, split by kernel and by recurrent
    scan (a scan's events hold the linears it launches: the sLSTM loop's
    two a token), and the device's busy time and idle share."""
    P = REC_PREFILL_SPLIT
    toks = torch.zeros(1, P, dtype=torch.int32, device=DEVICE)
    cache = model.cache_init(LM_BATCH, LM_MAX_LEN, DEVICE)
    run = lambda: engine._prefill_slot(  # noqa: E731
        engine.params, toks, P, 0, cache)
    run()
    total = time_ms(run, iters=3, warmup=1)
    want = lm_launches(model.cfg, P)
    by_kernel = kernel_breakdown(torch, run, [n for n, c in want.items()
                                              if c])
    by_scan = kernel_breakdown(torch, run, [
        n for n, k in REC_SCANS.items() if k in model.cfg.layer_kinds])
    busy = device_ms(run, iters=1, cats=BUSY_CATS)
    out = {"tokens": P, "ms_events": total, "launches": sum(want.values()),
           "ms_by_kernel": by_kernel,
           "ms_other": total - sum(by_kernel.values()),
           "ms_by_scan": by_scan, "device_busy_ms": busy,
           "device_idle_share": idle_share(busy, total)}
    log(f"[{tag}] a {P}-token slot prefill {total!r} ms by events, "
        f"{out['launches']} launches; by kernel {by_kernel}, other "
        f"{out['ms_other']!r}; by scan (their linears inside) {by_scan}; "
        f"device busy {busy!r} ms, idle share {out['device_idle_share']!r}")
    del cache
    return out


def recurrent_phases(torch, np, phase):
    """Each of ``REC_LMS`` at full width and depth: served (the LM serve
    phase's checks, every call's launches from ``lm_launches``), one
    slot prefill split by kernel and scan and a 1024-token score (with an
    attention layer, a ``REC_SOFTMAX_SCORE``-token one too; their card-
    against-CPU checks: ``card_vs_cpu_phases``).  Every earlier model is
    freed first."""
    import importlib
    torch.cuda.empty_cache()
    out = {}
    for name in REC_LMS:
        full = importlib.import_module(f"repro_torch.configs.{name}").FULL
        model, engine, serve = phase(
            f"{name} serve", lm_serve_phase, torch, np, full, REC_PROMPTS,
            REC_NEW_TOKENS, name)
        check_full_depth_launches(name, serve)
        serve["prefill_split"] = prefill_split(torch, model, engine, name)
        res = {"serve": serve}
        res["score"], _ = phase(f"{name} score", lm_score_phase, torch, np,
                                model, engine, f"{name} score",
                                LM_SCORE_TOKENS, "attn" in full.layer_kinds)
        if "attn" in full.layer_kinds:
            res["score_softmax"], _ = phase(
                f"{name} score {REC_SOFTMAX_SCORE}", lm_score_phase, torch,
                np, model, engine, f"{name} score {REC_SOFTMAX_SCORE}",
                REC_SOFTMAX_SCORE)
        del model, engine
        torch.cuda.empty_cache()
        out[name] = res
    return out


def timed_generate(torch, engine, batch, new_tokens, want, tag):
    """``engine.generate(batch, new_tokens)`` with the prefill and every
    decode step timed (host clock after a synchronize) and their launches
    held to ``want(kind)``, kind "prefill" or "decode"; returns (tokens,
    prefill ms, the decode steps' ms)."""
    calls = []
    prefill, decode = engine._prefill, engine._decode

    def timed(kind, fn):
        def call(*a, **k):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((kind, (time.perf_counter() - t) * 1e3,
                          count_diff(read_counts(), before)))
            return out
        return call

    engine._prefill = timed("prefill", prefill)
    engine._decode = timed("decode", decode)
    try:
        toks = engine.generate(batch, max_new_tokens=new_tokens)
    finally:
        engine._prefill, engine._decode = prefill, decode
    for kind, _, got in calls:
        if got != want(kind):
            raise AssertionError(f"{tag}: {kind} launched {got}, expected "
                                 f"{want(kind)}")
    pre = [ms for kind, ms, _ in calls if kind == "prefill"]
    dec = [ms for kind, ms, _ in calls if kind == "decode"]
    if len(pre) != 1 or len(dec) != new_tokens - 1:
        raise AssertionError(f"{tag}: {len(pre)} prefills and {len(dec)} "
                             f"decode steps")
    return toks, pre[0], dec


def check_tokens(tag, toks, rows, new_tokens, vocab):
    if tuple(toks.shape) != (rows, new_tokens) or \
            not bool(((toks >= 0) & (toks < vocab)).all()):
        raise AssertionError(f"{tag}: generated {tuple(toks.shape)} tokens "
                             f"outside the vocabulary")


def vision_batch(np, rows, vision, text, cfg, seed):
    """A VLM batch: ``vision`` + ``text`` tokens a row (the first
    ``vision`` positions are overwritten by the projected embeddings) and
    float32 vision embeddings."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(
                rows, vision + text)).astype(np.int32),
            "vision_embeds": rng.normal(size=(
                rows, vision, cfg.vision_dim)).astype(np.float32)}


def vlm_phase(torch, np):
    """LLaVA-NeXT-Mistral-7B at full width and depth on random packed
    MXInt8 planes: ``VLM_BATCH`` requests of 2880 vision positions and
    ``VLM_TEXT`` text tokens through ``ServingEngine.generate``,
    ``VLM_NEW_TOKENS`` new, ``max_len`` ``VLM_MAX_LEN``; the launches of
    the prefill (the projector's linear, the layers' float prefill
    attention) and of every decode step held to ``lm_launches``; one
    decode step split by kernel beside the unembedding; then a
    ``VLM_BATCH`` x 3072-position score with vision embeddings (the flash
    kernel), its launches held too."""
    from repro_torch.configs import llava_next_mistral_7b as llava
    from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    tag = "llava"
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llava.FULL, quant=QuantConfig(
        mode="kernel", quantize_nonlinear=True))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=DEVICE, pack_fmt=MXINT8_WEIGHT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, ServeConfig(
        max_len=VLM_MAX_LEN, batch=VLM_BATCH, pack_weights=True,
        weight_fmt=MXINT8_WEIGHT), device=DEVICE)
    allocated = torch.cuda.memory_allocated() / 2 ** 30
    P = cfg.vision_tokens + VLM_TEXT
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.vision_tokens} vision positions of "
        f"{cfg.vision_dim}: packed on the card in {init_s!r} s, "
        f"{allocated!r} GiB allocated; vision_proj stays float "
        f"({type(engine.params['vision_proj'].value).__name__})")
    batch = vision_batch(np, VLM_BATCH, cfg.vision_tokens, VLM_TEXT, cfg,
                         SEED + 7)
    want = {"prefill": lm_launches(cfg, P, vision=True),
            "decode": lm_launches(cfg, 1, decode=True)}
    reset_counts()
    t0 = time.perf_counter()
    toks, pre_ms, dec_ms = timed_generate(torch, engine, batch,
                                          VLM_NEW_TOKENS, want.get, tag)
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    check_tokens(tag, toks, VLM_BATCH, VLM_NEW_TOKENS, cfg.vocab)
    peak = peak_gib(torch)
    stats = {"model": cfg.name, "layers": cfg.n_layers, "init_s": init_s,
             "gib_allocated": allocated, "peak_gib": peak,
             "batch": VLM_BATCH, "positions": P,
             "vision_positions": cfg.vision_tokens,
             "new_tokens": VLM_NEW_TOKENS, "max_len": VLM_MAX_LEN,
             "serve_s": serve_s, "prefill_ms": pre_ms, "decode_ms": dec_ms,
             "decode_ms_median": statistics.median(dec_ms),
             "launches_per_prefill": sum(want["prefill"].values()),
             "launches_per_decode_step": sum(want["decode"].values()),
             "launches": launches, "tokens": toks.tolist()}
    log(f"[{tag}] {VLM_BATCH} requests of {P} positions, {VLM_NEW_TOKENS} "
        f"new tokens in {serve_s!r} s: prefill {pre_ms!r} ms "
        f"({stats['launches_per_prefill']} launches), decode ms per step "
        f"median {stats['decode_ms_median']!r} (min {min(dec_ms)!r}, max "
        f"{max(dec_ms)!r}; {stats['launches_per_decode_step']} launches); "
        f"peak {peak!r} GiB allocated; launches {launches}")
    # one decode step split by kernel, rows at the served depth
    cache = model.cache_init(VLM_BATCH, VLM_MAX_LEN, DEVICE)
    cache["index"] = torch.full((VLM_BATCH,), P + VLM_NEW_TOKENS // 2,
                                dtype=torch.int32, device=DEVICE)
    step = lambda: engine._decode(engine.params, torch.zeros(  # noqa: E731
        VLM_BATCH, 1, dtype=torch.int32, device=DEVICE), cache)
    step()
    step_total = time_ms(step, iters=5)
    by_kernel = kernel_breakdown(torch, step, [
        n for n, c in want["decode"].items() if c])
    busy = device_ms(step, iters=3, cats=BUSY_CATS)
    h_last = torch.randn(VLM_BATCH, 1, cfg.d_model,
                         device=DEVICE).to(cfg.dtype)
    unembed = lambda: model.logits(engine.params, h_last)  # noqa: E731
    stats.update(decode_step_ms_events=step_total,
                 decode_step_ms_by_kernel=by_kernel,
                 decode_step_ms_other=step_total - sum(by_kernel.values()),
                 decode_step_device_busy_ms=busy,
                 decode_step_device_idle_share=idle_share(busy, step_total),
                 unembed_ms_events=time_ms(unembed, iters=5))
    log(f"[{tag}] one decode step {step_total!r} ms by kernel {by_kernel}, "
        f"other {stats['decode_step_ms_other']!r}; device busy {busy!r} ms, "
        f"idle share {stats['decode_step_device_idle_share']!r}; the "
        f"unembedding {stats['unembed_ms_events']!r} ms")
    del cache
    # the prefill split by kernel (the projector is one mxint_matmul)
    pre_cache = model.cache_init(VLM_BATCH, VLM_MAX_LEN, DEVICE)
    tb = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    run = lambda: engine._prefill(engine.params, tb, pre_cache)  # noqa: E731
    stats["prefill_ms_by_kernel"] = kernel_breakdown(torch, run, [
        n for n, c in want["prefill"].items() if c])
    log(f"[{tag}] the prefill by kernel {stats['prefill_ms_by_kernel']}")
    del pre_cache
    # a score with vision embeddings: the flash kernel in every layer
    with torch.no_grad():
        sb = {"tokens": tb["tokens"][:1], "vision_embeds":
              tb["vision_embeds"][:1]}
        model.loss(engine.params, sb)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = float(model.loss(engine.params, sb))
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) * 1e3
        got = read_counts()
        want_score = lm_launches(cfg, P, score=True, vision=True)
        if got != want_score:
            raise AssertionError(f"{tag} score: launched {got}, expected "
                                 f"{want_score}")
        if not (0.0 < loss < 2.0 * float(np.log(cfg.vocab))):
            raise AssertionError(f"{tag} score: loss {loss}")
        by_kernel = kernel_breakdown(torch, lambda: model.loss(
            engine.params, sb), [n for n, c in want_score.items() if c])
    stats["score"] = {"positions": P, "loss": loss, "ms": score_ms,
                      "launches": got, "ms_by_kernel": by_kernel}
    log(f"[{tag} score] {P} positions with vision embeddings: loss "
        f"{loss!r}, {score_ms!r} ms, launches {got}; by kernel {by_kernel}")
    for what, n in (("prefill", stats["launches_per_prefill"]),
                    ("decode", stats["launches_per_decode_step"]),
                    ("score", sum(want_score.values()))):
        if n != VLM_LAUNCHES[what]:
            raise AssertionError(f"{tag}: {n} launches a {what}, not "
                                 f"{VLM_LAUNCHES[what]}")
    del model, engine, params
    torch.cuda.empty_cache()
    return stats


def compare_card_cpu(tag, out):
    """Raise unless the card's and the CPU's tokens are identical and
    their logits agree in argmax and within 1e-3 of their scale; returns
    the comparison.  ``out[dev]`` = (tokens, logits numpy)."""
    import numpy as np
    (tg, lg), (tc, lc) = out[DEVICE], out["cpu"]
    gap, scale = float(np.abs(lg - lc).max()), float(np.abs(lc).max())
    diff = int((lg.argmax(-1) != lc.argmax(-1)).sum())
    res = {"tokens_card": tg, "tokens_cpu": tc, "logits_max_abs_gap": gap,
           "logits_scale": scale, "argmax_differ": diff,
           "logits_differing_elements": int((lg != lc).sum()),
           "positions": int(np.prod(lg.shape[:-1]))}
    log(f"[{tag}] tokens card={tg} cpu={tc}; logits max_abs_gap={gap!r} "
        f"scale={scale!r}, differing elements "
        f"{res['logits_differing_elements']}, argmax differs at {diff} of "
        f"{res['positions']} positions")
    if tg != tc:
        raise AssertionError(f"{tag}: card and CPU generated different "
                             f"tokens")
    if diff or gap > 1e-3 * scale:
        raise AssertionError(f"{tag}: card and CPU logits disagree beyond "
                             f"1e-3 of their scale or in argmax")
    return res


def vlm_side(dev, cfg, planes, serve, score):
    """One side of LLaVA's card-against-CPU check on ``dev``: ``serve``
    through ``generate`` (4 new tokens) and ``score``'s forward; returns
    (tokens, logits, seconds, launches)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    model = build_model(cfg)
    t0 = time.perf_counter()
    reset_counts()
    eng = ServingEngine(model, planes, ServeConfig(max_len=1024, batch=2),
                        device=dev)
    toks = eng.generate(serve, max_new_tokens=4).tolist()
    logits = model.forward(eng.params, score["tokens"],
                           torch.as_tensor(score["vision_embeds"]))
    logits = logits.float().cpu().numpy()
    if dev != "cpu":
        torch.cuda.synchronize()
    return toks, logits, time.perf_counter() - t0, read_counts()


def vlm_cpu_phase(torch, np):
    """LLaVA at full width, 1 layer, float32, ``VLM_CPU_VISION`` vision
    positions, in kernel mode on MXInt8 planes, on the card and on the
    CPU: 2 requests of ``VLM_CPU_VISION`` + ``VLM_CPU_TEXT`` positions
    through ``generate`` (4 new tokens; the whole-row prefill), and a
    ``VLM_CPU_SCORE``-position forward with vision embeddings (past 512 x
    512 scores: the flash kernel).  The CPU side is queued on
    ``CPU_CHECKS``; returns the function that compares."""
    from repro_torch.configs import llava_next_mistral_7b as llava
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.models import build_model

    cfg = dataclasses.replace(
        cut_depth(llava.FULL, 1), dtype=torch.float32,
        vision_tokens=VLM_CPU_VISION,
        quant=QuantConfig(mode="kernel", quantize_nonlinear=True))
    _, planes = cpu_check_params(torch, build_model(cfg))
    serve = vision_batch(np, 2, VLM_CPU_VISION, VLM_CPU_TEXT, cfg, SEED + 8)
    score = vision_batch(np, 1, VLM_CPU_VISION,
                         VLM_CPU_SCORE - VLM_CPU_VISION, cfg, SEED + 9)
    card = vlm_side(DEVICE, cfg, planes, serve, score)
    log(f"[vlm cpu] {DEVICE}: served and scored in {card[2]!r} s")
    launches = card[3]
    if not launches["flash_attention"]:
        raise AssertionError("vlm cpu: the score did not take the flash "
                             "kernel")
    job = CPU_CHECKS.add("vlm cpu", vlm_side, "cpu", cfg, planes, serve,
                         score)

    def finish():
        cpu = CPU_CHECKS.result(job)
        log(f"[vlm cpu] cpu: served and scored in {cpu[2]!r} s")
        res = compare_card_cpu("vlm cpu", {DEVICE: card[:2],
                                           "cpu": cpu[:2]})
        res.update(layers=1, vision_positions=VLM_CPU_VISION,
                   prompt_positions=VLM_CPU_VISION + VLM_CPU_TEXT,
                   score_positions=VLM_CPU_SCORE, card_launches=launches,
                   card_s=card[2], cpu_s=cpu[2])
        return res

    return finish


def frames_batch(np, rows, frames, tokens, cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(
                rows, tokens)).astype(np.int32),
            "frames": rng.normal(size=(rows, frames, cfg.d_model)).astype(
                np.float32)}


def encdec_phase(torch, np):
    """SeamlessM4T-medium at full width and depth (12 + 12 layers) on
    random packed MXInt8 planes: ``LM_BATCH`` requests of
    ``ENCDEC_FRAMES`` frames and ``ENCDEC_PROMPT`` prompt tokens through
    ``ServingEngine.generate`` (``ENCDEC_NEW_TOKENS`` new), then one batch
    at ``ENCDEC_SHORT_FRAMES`` frames (the whole-row encoder); every
    prefill's and decode step's launches held to ``encdec_launches``;
    the encoder, ``encode_kv``, a decode step (split by kernel) and the
    unembedding timed."""
    from repro_torch.configs import seamless_m4t_medium as seamless
    from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    tag = "seamless"
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(seamless.FULL, quant=QuantConfig(
        mode="kernel", quantize_nonlinear=True))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=DEVICE, pack_fmt=MXINT8_WEIGHT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, ServeConfig(
        max_len=ENCDEC_MAX_LEN, batch=LM_BATCH, pack_weights=True,
        weight_fmt=MXINT8_WEIGHT), device=DEVICE)
    allocated = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[{tag}] {cfg.name} {cfg.n_encoder_layers} + {cfg.n_layers} "
        f"layers, d {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}: packed on the card in {init_s!r} s, "
        f"{allocated!r} GiB allocated")
    stats = {"model": cfg.name, "layers": [cfg.n_encoder_layers,
                                           cfg.n_layers],
             "init_s": init_s, "gib_allocated": allocated,
             "batch": LM_BATCH, "prompt": ENCDEC_PROMPT,
             "new_tokens": ENCDEC_NEW_TOKENS, "max_len": ENCDEC_MAX_LEN}
    for frames in (ENCDEC_FRAMES, ENCDEC_SHORT_FRAMES):
        batch = frames_batch(np, LM_BATCH, frames, ENCDEC_PROMPT, cfg,
                             SEED + frames)
        want = {"prefill": encdec_launches(cfg, frames, ENCDEC_PROMPT),
                "decode": encdec_launches(cfg, frames, 1, decode=True)}
        reset_counts()
        t0 = time.perf_counter()
        toks, pre_ms, dec_ms = timed_generate(
            torch, engine, batch, ENCDEC_NEW_TOKENS, want.get, tag)
        serve_s = time.perf_counter() - t0
        launches = read_counts()
        check_tokens(tag, toks, LM_BATCH, ENCDEC_NEW_TOKENS, cfg.vocab)
        n = {k: sum(v.values()) for k, v in want.items()}
        if (n["prefill"], n["decode"]) != ENCDEC_LAUNCHES[frames]:
            raise AssertionError(f"{tag}: {n} launches at {frames} frames, "
                                 f"not {ENCDEC_LAUNCHES[frames]}")
        stats[f"serve_{frames}"] = {
            "frames": frames, "serve_s": serve_s, "prefill_ms": pre_ms,
            "decode_ms": dec_ms, "decode_ms_median": statistics.median(
                dec_ms), "launches_per_prefill": n["prefill"],
            "launches_per_decode_step": n["decode"], "launches": launches,
            "tokens": toks.tolist()}
        log(f"[{tag}] {LM_BATCH} requests of {frames} frames and "
            f"{ENCDEC_PROMPT} tokens, {ENCDEC_NEW_TOKENS} new, in {serve_s!r}"
            f" s: prefill {pre_ms!r} ms ({n['prefill']} launches), decode ms "
            f"per step median {statistics.median(dec_ms)!r} (min "
            f"{min(dec_ms)!r}, max {max(dec_ms)!r}; {n['decode']} launches);"
            f" launches {launches}")
    stats["peak_gib"] = peak_gib(torch)
    # the encoder and encode_kv at ENCDEC_FRAMES frames, a decode step
    batch = frames_batch(np, LM_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, cfg,
                         SEED + ENCDEC_FRAMES)
    frames = torch.as_tensor(batch["frames"], device=DEVICE)
    with torch.no_grad():
        memory = model.encode(engine.params, frames)
        stats["encode_ms"] = time_ms(
            lambda: model.encode(engine.params, frames), iters=3)
        stats["encode_ms_by_kernel"] = kernel_breakdown(
            torch, lambda: model.encode(engine.params, frames),
            ["mxint_matmul", "mxint_layernorm", "mxint_gelu",
             "flash_attention"])
        stats["encode_kv_ms"] = time_ms(
            lambda: model.encode_kv(engine.params, memory), iters=3)
        cache = model.cache_init(LM_BATCH, ENCDEC_MAX_LEN, DEVICE)
        _, cache = engine._prefill(engine.params, {
            "frames": frames, "tokens": torch.as_tensor(
                batch["tokens"], device=DEVICE)}, cache)
        tok = torch.zeros(LM_BATCH, 1, dtype=torch.int32, device=DEVICE)

        def step():
            cache["index"] = torch.full((), ENCDEC_PROMPT, dtype=torch.int32,
                                        device=DEVICE)
            return engine._decode(engine.params, tok, cache)

        step()
        step_total = time_ms(step, iters=5)
        names = [n for n, c in encdec_launches(
            cfg, ENCDEC_FRAMES, 1, decode=True).items() if c]
        by_kernel = kernel_breakdown(torch, step, names)
        busy = device_ms(step, iters=3, cats=BUSY_CATS)
        h_last = torch.randn(LM_BATCH, 1, cfg.d_model,
                             device=DEVICE).to(cfg.dtype)
        stats.update(
            decode_step_ms_events=step_total,
            decode_step_ms_by_kernel=by_kernel,
            decode_step_ms_other=step_total - sum(by_kernel.values()),
            decode_step_device_busy_ms=busy,
            decode_step_device_idle_share=idle_share(busy, step_total),
            unembed_ms_events=time_ms(lambda: model.logits(
                engine.params, h_last), iters=5))
    log(f"[{tag}] the encoder at {ENCDEC_FRAMES} frames {stats['encode_ms']!r}"
        f" ms by kernel {stats['encode_ms_by_kernel']}; encode_kv "
        f"{stats['encode_kv_ms']!r} ms; one decode step {step_total!r} ms by "
        f"kernel {by_kernel}, other {stats['decode_step_ms_other']!r}; "
        f"device busy {busy!r} ms, idle share "
        f"{stats['decode_step_device_idle_share']!r}; the unembedding "
        f"({cfg.vocab} x {cfg.d_model}) {stats['unembed_ms_events']!r} ms; "
        f"peak {stats['peak_gib']!r} GiB")
    del cache, memory, model, engine, params
    torch.cuda.empty_cache()
    return stats


def encdec_side(dev, cfg, planes, batch):
    """One side of Seamless's card-against-CPU check on ``dev``: ``batch``
    through ``generate`` (4 new tokens) and a cache-less forward; returns
    (tokens, logits, seconds, launches)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    model = build_model(cfg)
    t0 = time.perf_counter()
    reset_counts()
    eng = ServingEngine(model, planes, ServeConfig(max_len=64, batch=2),
                        device=dev)
    toks = eng.generate(batch, max_new_tokens=4).tolist()
    logits = model.forward(eng.params, batch["frames"], batch["tokens"])
    logits = logits.float().cpu().numpy()
    if dev != "cpu":
        torch.cuda.synchronize()
    return toks, logits, time.perf_counter() - t0, read_counts()


def encdec_cpu_phase(torch, np):
    """SeamlessM4T-medium at full width, 1 + 1 layers, float32, kernel
    mode on MXInt8 planes, on the card and on the CPU, at each of
    ``ENCDEC_CPU_FRAMES`` frames (256: the whole-row encoder; 640: the
    flash kernel): 2 requests of ``ENCDEC_PROMPT`` tokens through
    ``generate`` (4 new), and a cache-less forward's logits.  The CPU
    sides are queued on ``CPU_CHECKS``; returns the function that
    compares."""
    from repro_torch.configs import seamless_m4t_medium as seamless
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.models import build_model

    cfg = dataclasses.replace(
        seamless.FULL, n_layers=1, n_encoder_layers=1, dtype=torch.float32,
        quant=QuantConfig(mode="kernel", quantize_nonlinear=True))
    _, planes = cpu_check_params(torch, build_model(cfg))
    pending = {}
    for frames in ENCDEC_CPU_FRAMES:
        batch = frames_batch(np, 2, frames, ENCDEC_PROMPT, cfg, SEED + 11)
        card = encdec_side(DEVICE, cfg, planes, batch)
        log(f"[encdec cpu {frames}] {DEVICE}: served and scored in "
            f"{card[2]!r} s")
        encoder = "flash_attention" if frames * frames > 512 * 512 \
            else "mxint_softmax"
        if not card[3][encoder]:
            raise AssertionError(f"encdec cpu {frames}: the encoder did not "
                                 f"take {encoder}")
        pending[frames] = (card, CPU_CHECKS.add(
            f"encdec cpu {frames}", encdec_side, "cpu", cfg, planes, batch))

    def finish():
        results = {}
        for frames, (card, job) in pending.items():
            cpu = CPU_CHECKS.result(job)
            log(f"[encdec cpu {frames}] cpu: served and scored in "
                f"{cpu[2]!r} s")
            res = compare_card_cpu(f"encdec cpu {frames}", {
                DEVICE: card[:2], "cpu": cpu[:2]})
            res.update(frames=frames, layers=[1, 1], card_launches=card[3],
                       card_s=card[2], cpu_s=cpu[2])
            results[frames] = res
        return results

    return finish


def warm_cpu(torch):
    """Run each transcendental op once on one element: the CPU build may
    compute them inexactly on a first multi-threaded call."""
    for fn in (torch.exp, torch.sin, torch.cos, torch.log, torch.erf):
        fn(torch.ones(1))
        fn(torch.ones(1, dtype=torch.float64))


def cpu_check_params(torch, model):
    """(float parameters, the same packed to MXInt8 planes), both on the
    CPU, for a card-against-CPU check: drawn and packed on the card (the
    CPU takes many times as long to draw a full-width model), then copied,
    so both sides read the same values."""
    from repro_torch.core.mx_types import MXINT8_WEIGHT
    from repro_torch.serving.engine import pack_params_mxint, params_to
    floats = model.init(SEED, device=DEVICE)
    planes = params_to(pack_params_mxint(floats, MXINT8_WEIGHT,
                                         model.layer_stacks()), "cpu")
    floats = params_to(floats, "cpu")
    torch.cuda.empty_cache()
    return floats, planes


def rec_train_phase(torch, np):
    """Training the recurrent families and the two new decoders (module
    docstring, item 20): RecurrentGemma-2B at full width and
    ``REC_TRAIN_UNITS`` units, xLSTM-350M at full width and depth, each
    ``REC_TRAIN_STEPS`` steps in "off" (``train_full``); then the SMOKE
    RecurrentGemma, xLSTM, LLaVA and Seamless each card against CPU
    (``smoke_card_vs_cpu``)."""
    import importlib
    out = {}
    for name, units in REC_TRAIN_UNITS.items():
        full = importlib.import_module(f"repro_torch.configs.{name}").FULL
        cfg = dataclasses.replace(full if units is None else
                                  cut_depth(full, units),
                                  dtype=torch.float32)
        out[name] = train_full(torch, np, "rec train", name, cfg,
                               REC_TRAIN_STEPS, REC_TRAIN_BATCH,
                               REC_TRAIN_SEQ)
    for name in REC_TRAIN_SMOKES:
        cfg = importlib.import_module(f"repro_torch.configs.{name}").SMOKE
        out[f"{name}_smoke_card_vs_cpu"] = smoke_card_vs_cpu(
            torch, np, "rec train", name, cfg)
    return out


# ---------------------------------------------------------------------------
# training (phases 17-20)
# ---------------------------------------------------------------------------
def peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


def state_leaves(state):
    from repro_torch.train.checkpoint import _flatten
    return [(p, t.detach()) for p, t, _ in _flatten(state)]


def state_gap(a, b):
    """(leaves that differ, the largest gap over its leaf's scale) of two
    train states of one structure."""
    differ, worst = 0, 0.0
    for (pa, ta), (pb, tb) in zip(state_leaves(a), state_leaves(b)):
        if pa != pb:
            raise AssertionError(f"state paths differ: {pa} {pb}")
        if not bool((ta == tb).all()):
            differ += 1
            gap = float((ta.double() - tb.double()).abs().max())
            scale = float(tb.double().abs().max()) or 1.0
            worst = max(worst, gap / scale)
    return differ, worst


def timed_loop(torch, loop):
    """Bracket each of ``loop``'s steps with CUDA events, from its batch's
    draw to the train step's return (the ``train/step`` span holds the
    same work plus the loss readback)."""
    pairs, pending = [], []
    draw, step = loop.data.next_batch, loop.step_fn

    def next_batch():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pending.append(ev)
        return draw()

    def step_fn(state, batch):
        out = step(state, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs.append((pending.pop(), ev))
        return out

    loop.data.next_batch, loop.step_fn = next_batch, step_fn
    return pairs


def run_loop(torch, loop, start_step, tag):
    """Run ``loop`` from ``start_step``; its steps' losses, grad norms,
    span times and CUDA-event times."""
    from repro_torch import telemetry as T
    pairs = timed_loop(torch, loop)
    T.reset("span/train")
    metrics = loop.run(start_step=start_step)
    torch.cuda.synchronize()
    events = [s.elapsed_time(e) for s, e in pairs]
    n, span_mean = T.span_stats("train/step")
    ev_mean = statistics.mean(events)
    out = {"steps": [m["step"] for m in metrics],
           "loss": [m["loss"] for m in metrics],
           "grad_norm": [m["grad_norm"] for m in metrics],
           "step_ms": events, "step_ms_median": statistics.median(events),
           "step_ms_min": min(events), "step_ms_max": max(events),
           "span_ms_mean": span_mean, "events_ms_mean": ev_mean}
    log(f"[{tag}] steps {out['steps']}: loss {out['loss']} grad norm "
        f"{out['grad_norm']}")
    log(f"[{tag}] ms per step by CUDA events (batch draw to the step's "
        f"return) median {out['step_ms_median']!r} (min "
        f"{out['step_ms_min']!r}, max {out['step_ms_max']!r}), mean "
        f"{ev_mean!r}; train/step span mean {span_mean!r} ms over {n}")
    if n != len(metrics) or not span_mean >= ev_mean or \
            span_mean - ev_mean > max(0.05 * ev_mean, 5.0):
        raise AssertionError(f"{tag}: the train/step span ({span_mean!r} ms) "
                             f"is not the events' {ev_mean!r} ms plus the "
                             f"loss readback (5% or 5 ms)")
    if not all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]):
        raise AssertionError(f"{tag}: non-finite loss or grad norm")
    return out


def step_profile(torch, model, step_fn, state, batch, tag):
    """One train step on a fixed batch: ms by CUDA events, the device's
    busy ms and idle share from a trace, the device time by kernel name
    (the ten largest) and in the products' kernels (GEMMs), and the
    forward-backward and the AdamW update apart."""
    from repro_torch.models.model_api import Param, tree_leaves, \
        tree_unflatten
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.step import value_and_grad
    ms = time_ms(lambda: step_fn(state, batch), iters=2, warmup=1)
    events = trace_events(lambda: step_fn(state, batch), iters=1)
    busy = sum(e.get("dur", 0) for e in events) / 1e3
    by_name, by_kind = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            name, ms_k = short_kernel_name(e["name"]), e["dur"] / 1e3
            by_name[name] = by_name.get(name, 0.0) + ms_k
            kind = kernel_kind(e["name"])
            by_kind[kind] = by_kind.get(kind, 0.0) + ms_k
    gemm = by_kind.get("products (GEMMs)", 0.0)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    model_loss = lambda p, b: model.loss(p, b).float()  # noqa: E731
    fb_ms = time_ms(lambda: value_and_grad(model_loss, state.params, batch),
                    iters=2, warmup=1)
    _, grads = value_and_grad(model_loss, state.params, batch)
    gtree = tree_unflatten(state.params, [
        Param(g, p.axes) for g, p in zip(grads, tree_leaves(state.params))])
    lr = torch.tensor(1e-3, device=DEVICE)
    opt_ms = time_ms(lambda: adamw_update(gtree, state.opt, state.params, lr,
                                          AdamWConfig()), iters=3)
    out = {"ms_events": ms, "device_busy_ms": busy,
           "device_idle_share": idle_share(busy, ms),
           "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
           "device_ms_products": gemm,
           "device_ms_other_kernels": sum(by_name.values()) - gemm,
           "device_ms_by_kind": by_kind,
           "device_ms_by_kernel_top10": top,
           "forward_backward_ms": fb_ms, "adamw_ms": opt_ms}
    log(f"[{tag}] a step on a fixed batch {ms!r} ms: device busy {busy!r} "
        f"ms, idle share {out['device_idle_share']!r}, {out['kernels']} "
        f"kernels; products (GEMMs) {gemm!r} ms, other kernels "
        f"{out['device_ms_other_kernels']!r} ms; forward+backward {fb_ms!r} "
        f"ms, AdamW update {opt_ms!r} ms")
    log(f"[{tag}] device ms by kind {by_kind}; by kernel, top 10: {top}")
    return out


def kernel_kind(name: str) -> str:
    """The group of a device kernel in a training step's trace."""
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass")):
        return "products (GEMMs)"
    if "direct_copy_kernel" in name:
        return "copies and dtype casts"
    if "reduce_kernel" in name:
        return "reductions"
    return "other elementwise"


def short_kernel_name(name: str) -> str:
    """A trace kernel name without ATen's namespaces and template
    arguments, with the functor that tells elementwise kernels apart."""
    import re
    base = name.replace("void ", "").replace("at::native::", "")
    head = base.split("<", 1)[0]
    tags = [m.group(0) for m in (
        re.search(r"\w+Functor\w*<\w+>|\w+_kernel_(?:cuda|impl)", base),
        re.search(r"lambda\((?!int\))\w+\)", base)) if m]
    return head + (f"[{', '.join(tags)}]" if tags else "")


def deit_train(torch, np, mode, batch, steps, root, tag, resume_at=None):
    """DeiT-Base at full width and depth trained ``steps`` steps through
    ``TrainLoop`` in ``mode`` (the serving formats: weights MXInt6/256,
    acts MXInt8/16), checkpoints every ``resume_at`` steps; with
    ``resume_at``, a fresh loop from a fresh state then resumes from that
    checkpoint and runs to ``steps``, and both final states are
    compared."""
    import shutil
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.vit import ViT
    from repro_torch.optim.schedules import constant_schedule
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.train.loop import LoopConfig, TrainLoop

    model = ViT(dataclasses.replace(DEIT_BASE,
                                    quant=QuantConfig(mode=mode)))
    step_fn = make_train_step(model, lr_fn=lambda s: constant_schedule(
        s, TRAIN_LR))

    def data():
        return SyntheticImageData(n_classes=1000, image_size=224,
                                  batch=batch, seed=SEED, device=DEVICE)

    def loop(state, ck, total):
        return TrainLoop(train_step=step_fn, state=state, data=data(),
                         cfg=LoopConfig(
                             total_steps=total,
                             checkpoint_every=resume_at or 10 ** 6,
                             log_every=1, checkpoint_dir=str(ck),
                             metrics_path=str(root / f"{mode}.jsonl"),
                             heartbeat_path=str(root / f"{mode}_hb.json")))

    out = {"mode": mode, "batch": batch, "config":
           model.cfg.quant.describe()}
    state = make_train_state(model, SEED, DEVICE)
    probe = data().next_batch()
    # determinism: one step twice from one state and batch
    a, _ = step_fn(state, probe)
    b, _ = step_fn(state, probe)
    differ, worst = state_gap(a, b)
    out["repeat_step_differing_leaves"] = differ
    out["repeat_step_max_gap_over_scale"] = worst
    log(f"[{tag}] one step twice from one state: {differ} leaves differ "
        f"(largest gap / scale {worst!r})")
    del a, b
    out["profile"] = step_profile(torch, model, step_fn, state, probe, tag)
    del probe
    torch.cuda.reset_peak_memory_stats()
    straight = loop(state, root / f"{mode}_a", steps)
    out["straight"] = run_loop(torch, straight, 0, tag)
    out["peak_gib"] = peak_gib(torch)
    log(f"[{tag}] batch {batch}: peak {out['peak_gib']!r} GiB allocated")
    if resume_at is None:
        return out
    src = root / f"{mode}_a" / f"step_{resume_at:06d}"
    shutil.copytree(src, root / f"{mode}_b" / src.name)
    resumed = loop(make_train_state(model, SEED, DEVICE), root / f"{mode}_b",
                   steps)
    got = resumed.try_resume()
    if got != resume_at or resumed.data.state.next_index != resume_at or \
            int(resumed.state.step) != resume_at:
        raise AssertionError(f"{tag}: resumed at {got}, data at "
                             f"{resumed.data.state.next_index}")
    out["resumed"] = run_loop(torch, resumed, resume_at, f"{tag} resumed")
    differ, worst = state_gap(resumed.state, straight.state)
    out["resume_differing_leaves"] = differ
    out["resume_max_gap_over_scale"] = worst
    deterministic = out["repeat_step_differing_leaves"] == 0
    log(f"[{tag}] resumed at {resume_at} and run to {steps} against the "
        f"straight run: {differ} of {len(state_leaves(straight.state))} "
        f"leaves differ (largest gap / scale {worst!r}); the backward is "
        f"{'deterministic' if deterministic else 'not deterministic'}")
    if deterministic and differ:
        raise AssertionError(f"{tag}: the resumed run is not the straight "
                             f"run bit for bit")
    if not deterministic and worst > 10 * max(
            out["repeat_step_max_gap_over_scale"], 1e-7):
        raise AssertionError(f"{tag}: the resumed run is further from the "
                             f"straight run than repeated steps are")
    if out["resumed"]["loss"] != out["straight"]["loss"][resume_at:] and \
            deterministic:
        raise AssertionError(f"{tag}: resumed losses differ")
    return out


def grads_card_vs_cpu(torch, np):
    """One value-and-grad of DeiT-Micro (batch 16) in "off", "fake" and
    "sim" on the card and on the CPU from the same params and batch: the
    float64 products are rounded once in the backward as in the forward;
    what differs is the float32 sums over the batch of the broadcast
    leaves' gradients (biases, LayerNorm gains, class and position
    embeddings), which run in another order on each device, and the
    float32 log-softmax of the loss (held to 1e-6 relative)."""
    from repro_torch.configs.deit import DEIT_MICRO
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.vit import ViT
    from repro_torch.train import make_train_state, train_state_to
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.step import value_and_grad

    out = {}
    for mode, kw in (("off", {}), ("fake", {}),
                     ("sim", {"quantize_nonlinear": True})):
        model = ViT(dataclasses.replace(DEIT_MICRO, quant=QuantConfig(
            mode=mode, **kw)))
        state = make_train_state(model, SEED, "cpu")
        res = {}
        for dev in (DEVICE, "cpu"):
            st = train_state_to(state, dev)
            batch = SyntheticImageData(n_classes=10, batch=16, image_size=32,
                                       seed=SEED, device=dev).next_batch()
            loss, grads = value_and_grad(
                lambda p, b: model.loss(p, b).float(), st.params, batch)
            res[dev] = (float(loss), [g.cpu() for g in grads])
        names = [n for n, _, _ in _flatten(state.params)]
        differ = {n: int((a != b).sum()) for n, a, b in zip(
            names, res[DEVICE][1], res["cpu"][1]) if bool((a != b).any())}
        worst = max(float((a.double() - b.double()).abs().max()) /
                    (float(b.abs().max()) or 1.0)
                    for a, b in zip(res[DEVICE][1], res["cpu"][1]))
        out[mode] = {"loss_card": res[DEVICE][0], "loss_cpu": res["cpu"][0],
                     "leaves": len(names), "differing_elements_by_leaf":
                     differ, "max_gap_over_scale": worst}
        log(f"[train grads] DeiT-Micro {mode}: loss card {res[DEVICE][0]!r} "
            f"cpu {res['cpu'][0]!r}; gradients: {len(differ)} of "
            f"{len(names)} leaves differ {differ}, largest gap / scale "
            f"{worst!r} (limit {GRAD_CPU_TOL})")
        if abs(res[DEVICE][0] - res["cpu"][0]) > 1e-6 * abs(res["cpu"][0]) \
                or worst > GRAD_CPU_TOL:
            raise AssertionError(f"train grads {mode}: card and CPU differ "
                                 f"beyond {GRAD_CPU_TOL}")
    return out


def train_phase(torch, np):
    """Full-width DeiT-Base trained in "fake" with a checkpoint and a
    resume, then in "off"; DeiT-Micro's gradients card against CPU
    (module docstring, item 17)."""
    import shutil
    root = ROOT / "build" / "train_phase"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"fake": deit_train(torch, np, "fake", TRAIN_BATCH, TRAIN_STEPS,
                              root, "train fake",
                              resume_at=TRAIN_RESUME_AT)}
    torch.cuda.empty_cache()
    out["off"] = deit_train(torch, np, "off", TRAIN_BATCH, TRAIN_OFF_STEPS,
                            root, "train off")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["grads_card_vs_cpu"] = grads_card_vs_cpu(torch, np)
    return out


def accuracy_rows():
    """(label, mode, weight bits, act bits, emulate, packed planes): the
    float model, Table V's rows (``benchmarks/table5_quantization.py``)
    in "fake", and sim and kernel mode at MXInt8/MXInt8 and
    MXInt6/MXInt8 with the MXInt non-linears."""
    rows = [("float32", "off", None, None, None, False)]
    rows += [(name, "fake", w, a, em, False)
             for name, w, a, em in TABLE5_ROWS]
    rows += [(f"{mode}_w{w}a8", mode, w, 8, None, mode == "kernel")
             for mode in ("sim", "kernel") for w in (8, 6)]
    return rows


def accuracy_config(mode, w, a, emulate):
    from repro_torch.configs.deit import DEIT_MICRO
    from repro_torch.core.mx_types import MXFormat, QuantConfig
    base = dataclasses.replace(DEIT_MICRO, n_classes=ACC_TASK["n_classes"])
    if mode == "off":
        return base
    return dataclasses.replace(base, quant=QuantConfig(
        mode=mode, weight_fmt=MXFormat(mant_bits=w, block_size=256),
        act_fmt=MXFormat(mant_bits=a, block_size=16), emulate=emulate,
        quantize_nonlinear=mode in ("sim", "kernel")))


def eval_accuracy(torch, np, model, params, device):
    """``benchmarks/common.py``'s ``eval_accuracy``: the mean of
    ``model.accuracy`` over ACC_EVAL_BATCHES batches of 128 from seed
    ACC_EVAL_SEED; also the predicted classes."""
    from repro_torch.data.pipeline import SyntheticImageData
    d = SyntheticImageData(batch=128, seed=ACC_EVAL_SEED, device=device,
                           **ACC_TASK)
    accs, preds = [], []
    with torch.no_grad():
        for _ in range(ACC_EVAL_BATCHES):
            b = d.next_batch()
            accs.append(float(model.accuracy(params, b)))
            preds.append(model.logits(params, b["images"]).argmax(-1).cpu())
    return float(np.mean(accs)), torch.cat(preds)


def accuracy_phase(torch, np):
    """``benchmarks/common.py``'s micro-DeiT recipe trained on the card,
    then evaluated in every row of ``accuracy_rows`` (module docstring,
    item 18)."""
    from repro_torch.core.mx_types import MXFormat
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.model_api import Param, tree_map
    from repro_torch.models.vit import ViT
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serving.engine import pack_params_mxint, params_to
    from repro_torch.train import make_train_state, make_train_step

    t_phase = time.perf_counter()
    model = ViT(accuracy_config("off", None, None, None))
    state = make_train_state(model, SEED, DEVICE)
    step = make_train_step(model, lr_fn=lambda s: torch.tensor(
        ACC_LR, device=DEVICE), opt_cfg=AdamWConfig(weight_decay=0.01))
    data = SyntheticImageData(batch=64, seed=SEED, device=DEVICE, **ACC_TASK)
    first, _ = step(state, data.batch_at(0))             # warm
    del first
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = []
    for i in range(ACC_STEPS):
        state, m = step(state, data.next_batch())
        if i % 100 == 0 or i == ACC_STEPS - 1:
            losses.append((i + 1, float(m["loss"])))
    end.record()
    end.synchronize()
    train_s = time.perf_counter() - t0
    ms_step = start.elapsed_time(end) / ACC_STEPS
    log(f"[accuracy] trained {ACC_STEPS} steps (batch 64, lr {ACC_LR}, "
        f"weight decay 0.01) in {train_s!r} s: {ms_step!r} ms a step by "
        f"events; loss at steps {losses}")
    # the modes that carry no gradient are refused on the card too
    refused = []
    try:
        make_train_step(ViT(accuracy_config("kernel", 8, 8, None)),
                        lr_fn=lambda s: ACC_LR)
    except ValueError:
        refused.append("kernel mode")
    packed_state = state._replace(params=pack_params_mxint(
        state.params, MXFormat(mant_bits=8, block_size=256)))
    try:
        step(packed_state, data.next_batch())
    except ValueError:
        refused.append("packed planes")
    if refused != ["kernel mode", "packed planes"]:
        raise AssertionError(f"make_train_step refused only {refused}")
    del packed_state
    params = tree_map(lambda p: Param(p.value.detach(), p.axes),
                      state.params)
    params_cpu = params_to(params, "cpu")
    rows, preds = {}, {}
    kernel_launches = dict.fromkeys(read_counts(), 0)
    for label, mode, w, a, em, packed in accuracy_rows():
        m = ViT(accuracy_config(mode, w, a, em))
        p = (pack_params_mxint(params, MXFormat(mant_bits=w,
                                                 block_size=256))
             if packed else params)
        reset_counts()
        acc, preds[label] = eval_accuracy(torch, np, m, p, DEVICE)
        launches = read_counts()
        if mode == "kernel":
            for n, c in launches.items():
                kernel_launches[n] += c
            per_forward = 3 + 8 * m.cfg.n_layers
            want = 2 * ACC_EVAL_BATCHES * per_forward
            if sum(launches.values()) != want:
                raise AssertionError(f"accuracy {label}: {launches} "
                                     f"launches, not {want}")
        elif any(launches.values()):
            raise AssertionError(f"accuracy {label}: launched {launches}")
        rows[label] = {"accuracy": acc}
    base = rows["float32"]["accuracy"]
    for label, r in rows.items():
        r["delta"] = r["accuracy"] - base
    # the same trained params on the CPU: the plain versions in kernel
    # mode, and sim
    cpu = {}
    for label, mode, w, a, em, packed in accuracy_rows():
        if mode not in ("sim", "kernel"):
            continue
        m = ViT(accuracy_config(mode, w, a, em))
        p = (pack_params_mxint(params_cpu, MXFormat(mant_bits=w,
                                                     block_size=256))
             if packed else params_cpu)
        cpu[label], cpu_preds = eval_accuracy(torch, np, m, p, "cpu")
        rows[label]["cpu_accuracy"] = cpu[label]
        rows[label]["cpu_predictions_differ"] = int(
            (cpu_preds != preds[label]).sum())
        if cpu[label] != rows[label]["accuracy"]:
            raise AssertionError(f"accuracy {label}: card "
                                 f"{rows[label]['accuracy']!r}, CPU "
                                 f"{cpu[label]!r}")
    agreement = {w: float((preds[f"kernel_w{w}a8"] == preds[f"sim_w{w}a8"])
                          .float().mean()) for w in (8, 6)}
    accs = {k: r["accuracy"] for k, r in rows.items()}
    claims = {
        "mxint8_within_1pct": accs["mxint8_w8.03/a8.5"] >= base - 0.01,
        "monotone_mx_bits":
            accs["mxint4_w4.03/a6.5"] <= accs["mxint6_w6.03/a6.5"] + 0.02
            and accs["mxint6_w6.03/a8.5"] <= accs["mxint8_w8.03/a8.5"] + 0.02}
    for label, r in rows.items():
        log(f"[accuracy] {label}: accuracy {r['accuracy']!r} delta "
            f"{r['delta']!r}" + (f", CPU {r['cpu_accuracy']!r} "
                                 f"({r['cpu_predictions_differ']} of "
                                 f"{128 * ACC_EVAL_BATCHES} predictions "
                                 f"differ)" if "cpu_accuracy" in r else ""))
    log(f"[accuracy] kernel against sim argmax agreement {agreement}; "
        f"claims {claims}; kernel-mode launches {kernel_launches}")
    return {"steps": ACC_STEPS, "train_s": train_s, "ms_per_step": ms_step,
            "losses": losses, "refused": refused, "rows": rows,
            "kernel_vs_sim_argmax_agreement": agreement, "claims": claims,
            "phase_s": time.perf_counter() - t_phase}, kernel_launches


def _train_run(torch, cfg, steps, batch, seq):
    """``steps`` "off" steps of ``cfg`` on the card: (losses, grad norms,
    ms per step, the sLSTM loops' forward ms per step, peak GiB,
    parameters)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models import recurrent as R
    from repro_torch.models.model_api import tree_leaves
    from repro_torch.train import make_train_state, make_train_step

    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, SEED, DEVICE)
    n_params = sum(p.value.numel() for p in tree_leaves(state.params))
    step = make_train_step(
        model, lr_fn=lambda s: torch.tensor(1e-4, device=s.device))
    data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq_len=seq,
                           seed=5, device=DEVICE)
    ms, losses, norms, loop_ms = [], [], [], []
    scan, events = R.slstm_scan, []

    def timed_scan(*a, **k):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        res = scan(*a, **k)
        e.record()
        events.append((s, e))
        return res

    R.slstm_scan = timed_scan
    try:
        for _ in range(steps):
            b = data.next_batch()
            events.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, b)
            end.record()
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append(start.elapsed_time(end))
            loop_ms.append(sum(s.elapsed_time(e) for s, e in events))
    finally:
        R.slstm_scan = scan
    peak = peak_gib(torch)
    del state, step, model
    torch.cuda.empty_cache()
    return losses, norms, ms, loop_ms, peak, n_params


def train_full(torch, np, tag, name, cfg, steps, batch, seq):
    """``cfg`` (full width, float32) trained ``steps`` steps in "off" on
    the card on ``SyntheticLMData`` batches of ``batch`` x ``seq`` tokens,
    with the config's own ``remat``: ms per step by CUDA events (the first
    warm), the sLSTM loops' forward inside each step (events around every
    ``slstm_scan``: 0 without sLSTM layers), the peak GiB allocated;
    raises unless every loss and grad norm is finite.  With ``remat``
    "block", ``REMAT_COMPARE_STEPS`` steps without it follow in the same
    run, for what the recomputation costs and saves: the first step's
    loss (a forward from the same parameters) must equal the first run's
    bit for bit; whether the later ones do is logged (a repeated step
    need not be bit-identical on the card: some float32 gradient sums
    there use atomics)."""
    losses, norms, ms, loop_ms, peak, n_params = _train_run(
        torch, cfg, steps, batch, seq)
    res = {"layers": cfg.n_layers, "params": n_params, "batch": batch,
           "seq_len": seq, "remat": cfg.remat, "loss": losses,
           "grad_norm": norms, "step_ms": ms,
           "step_ms_median": statistics.median(ms),
           "slstm_loop_forward_ms": loop_ms,
           "slstm_loop_forward_share": [a / b for a, b in zip(loop_ms, ms)],
           "peak_gib": peak}
    log(f"[{tag}] {name} at full width, {cfg.n_layers} layers "
        f"({n_params} parameters, float32), batch {batch} x {seq}, remat "
        f"{cfg.remat!r}: ms per step {ms} (the first warm), the sLSTM "
        f"loops' forward {loop_ms} ms; peak {peak!r} GiB allocated; loss "
        f"{losses}, grad norm {norms}")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))):
        raise AssertionError(f"{tag} {name}: non-finite loss or grad norm")
    if cfg.remat != "none":
        l2, n2, ms2, _, peak2, _ = _train_run(
            torch, dataclasses.replace(cfg, remat="none"),
            REMAT_COMPARE_STEPS, batch, seq)
        same = (l2 == losses[:REMAT_COMPARE_STEPS]
                and n2 == norms[:REMAT_COMPARE_STEPS])
        res["no_remat"] = {"steps": REMAT_COMPARE_STEPS, "loss": l2,
                           "grad_norm": n2, "step_ms": ms2,
                           "peak_gib": peak2, "same_losses_and_norms": same}
        log(f"[{tag}] {name} without remat, {REMAT_COMPARE_STEPS} steps: ms "
            f"per step {ms2}, peak {peak2!r} GiB allocated (remat "
            f"{cfg.remat!r}: {ms[:REMAT_COMPARE_STEPS]}, {peak!r} GiB); "
            f"losses {l2}, grad norms {n2}: the same as with remat: {same}")
        if l2[0] != losses[0]:
            raise AssertionError(f"{tag} {name}: remat changed the first "
                                 f"step's loss")
    return res


def smoke_card_vs_cpu(torch, np, tag, name, cfg):
    """The SMOKE ``cfg`` trained ``LM_SMOKE_STEPS`` steps on the card and
    on the CPU from one initial state, each on its own copy of one stream
    (``SyntheticSeq2SeqData`` for an encoder-decoder, ``SyntheticLMData``
    with the config's vision embeddings otherwise): raises unless the
    losses agree within ``LM_SMOKE_LOSS_TOL`` relative; the differing
    state leaves and the largest parameter gap are logged."""
    from repro_torch.data.pipeline import (SyntheticLMData,
                                           SyntheticSeq2SeqData)
    from repro_torch.models import build_model
    from repro_torch.models.model_api import tree_leaves
    from repro_torch.train import (make_train_state, make_train_step,
                                   train_state_to)

    smoke = build_model(cfg)
    step = make_train_step(
        smoke, lr_fn=lambda s: torch.tensor(1e-4, device=s.device))
    states = {"cpu": make_train_state(smoke, SEED, "cpu")}
    states[DEVICE] = train_state_to(states["cpu"], DEVICE)
    curves = {}
    for dev in (DEVICE, "cpu"):
        if cfg.is_encoder_decoder:
            d = SyntheticSeq2SeqData(vocab=cfg.vocab, batch=4, seq_len=32,
                                     d_model=cfg.d_model, seed=5, device=dev)
        else:
            d = SyntheticLMData(vocab=cfg.vocab, batch=4, seq_len=32, seed=5,
                                vision_tokens=cfg.vision_tokens,
                                vision_dim=cfg.vision_dim, device=dev)
        curves[dev] = []
        for _ in range(LM_SMOKE_STEPS):
            states[dev], m = step(states[dev], d.next_batch())
            curves[dev].append(float(m["loss"]))
    rel = max(abs(g - c) / abs(c) for g, c in zip(curves[DEVICE],
                                                   curves["cpu"]))
    differ, worst = state_gap(train_state_to(states[DEVICE], "cpu"),
                              states["cpu"])
    par = max(float((a.value.detach().cpu() - b.value.detach()).abs().max())
              for a, b in zip(tree_leaves(states[DEVICE].params),
                              tree_leaves(states["cpu"].params)))
    res = {"steps": LM_SMOKE_STEPS, "loss_card": curves[DEVICE],
           "loss_cpu": curves["cpu"], "max_loss_gap_rel": rel,
           "tolerance": LM_SMOKE_LOSS_TOL, "differing_leaves": differ,
           "max_gap_over_scale": worst, "max_param_gap": par}
    log(f"[{tag}] SMOKE {name}, {LM_SMOKE_STEPS} steps card against CPU: "
        f"losses {curves[DEVICE]} / {curves['cpu']}, largest relative gap "
        f"{rel!r} (limit {LM_SMOKE_LOSS_TOL}); {differ} state leaves "
        f"differ, largest gap / scale {worst!r}, largest parameter gap "
        f"{par!r}")
    if rel > LM_SMOKE_LOSS_TOL:
        raise AssertionError(f"{tag} {name}: card and CPU losses differ "
                             f"beyond {LM_SMOKE_LOSS_TOL}")
    return res


def lm_train_phase(torch, np):
    """Llama-3-8B at full width, LM_TRAIN_LAYERS layers, trained in "off"
    (``train_full``); then the SMOKE Llama-3 card against CPU
    (``smoke_card_vs_cpu``; module docstring, item 19)."""
    from repro_torch.configs import llama3_8b
    cfg = dataclasses.replace(llama3_8b.FULL, n_layers=LM_TRAIN_LAYERS,
                              dtype=torch.float32)
    out = train_full(torch, np, "lm train", "llama3_8b", cfg,
                     LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    out["smoke_card_vs_cpu"] = smoke_card_vs_cpu(
        torch, np, "lm train", "llama3_8b", llama3_8b.SMOKE)
    return out


# The launch phase: the dry run's predictions (``repro_torch.launch``) for
# Llama-3-8B at full width cut to ``LAUNCH_LAYERS`` layers, on the one-card
# mesh (1, 1), where the even split is no assumption, held against the
# same step on the card: resident bytes against what placing the
# arguments requests (``requested_bytes``, within ``LAUNCH_ROUND`` bytes a
# tensor; the allocator's blocks above the requests printed), the
# FLOPs against ``FlopCounterMode`` on the card (the same aten ops:
# equal), the live peak against ``max_memory_allocated`` above the
# arguments within ``LAUNCH_PEAK_TOL`` of the measured peak.  Then the
# CLI, in a subprocess, for one production cell.
LAUNCH_LAYERS = 2
LAUNCH_CELLS = (("decode", "mxint", 2048, 4), ("train", "bf16", 256, 2))
LAUNCH_ROUND = 512
# measured (chip runs 2 and 4): -4e-9 (decode) and +1.0e-7 (train) of the
# peak
LAUNCH_PEAK_TOL = 1e-3
LAUNCH_CLI = ("--arch", "llama3_8b", "--shape", "decode_32k", "--mesh",
              "single")
LAUNCH_OUT = ROOT / "build" / "launch_smoke"


# the processes the smoke starts beside its phases; any still running at
# exit (a phase failed first) is stopped
CHILDREN = []


def _stop_children():
    for p in CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def child(args):
    """Start ``python -m args...`` from the checkout's root, its output
    piped; the smoke stops it at exit if it still runs."""
    p = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=str(ROOT), text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    CHILDREN.append(p)
    return p


def start_launch_cli():
    """Start the dry run's CLI on one production cell: it needs no card,
    so it runs beside other phases.  Returns (the process, its start)."""
    return child(["repro_torch.launch.dryrun", *LAUNCH_CLI, "--out",
                  str(LAUNCH_OUT), "--tag", "smoke"]), time.perf_counter()


def launch_phase(torch, np, smi, cli):
    """The launch dry run held against one card, and the CLI's cell
    (``start_launch_cli``) checked (module docstring, item 22b)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import llama3_8b
    from repro_torch.launch import dryrun as D
    from repro_torch.models.model_api import ShapeConfig
    cfg = cut_depth(llama3_8b.FULL, LAUNCH_LAYERS)
    mesh = {"data": 1, "model": 1}
    out = {"card": smi, "layers": LAUNCH_LAYERS, "cells": {}}
    for kind, variant, seq, batch in LAUNCH_CELLS:
        tag = f"launch {kind} {variant}"
        shape = ShapeConfig(f"{kind}_b{batch}_s{seq}", seq, batch, kind)
        t = time.perf_counter()
        rec, _ = D.run_cell(cfg, shape, mesh, variant=variant)
        dry_s = time.perf_counter() - t
        roof = rec["roofline"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        stats0 = torch.cuda.memory_stats()
        cell = D.build_cell(cfg, shape, mesh, variant=variant,
                            device=DEVICE, seed=SEED)
        torch.cuda.synchronize()
        stats1 = torch.cuda.memory_stats()
        from torch.utils._pytree import tree_flatten
        n_tensors = sum(isinstance(t, torch.Tensor)
                        for t in tree_flatten(cell.args)[0])
        key_a, key_r = "allocated_bytes.all.current", \
            "requested_bytes.all.current"
        allocated = stats1[key_a] - stats0[key_a]
        requested = stats1[key_r] - stats0[key_r]
        predicted = rec["resident_bytes"]["total"]
        log(f"[{tag}] resident bytes predicted {predicted} (params "
            f"{rec['resident_bytes']['params']}, state "
            f"{rec['resident_bytes']['opt_state']}, cache "
            f"{rec['resident_bytes']['cache']}, batch "
            f"{rec['resident_bytes']['batch']}), placed: requested "
            f"{requested}, allocated {allocated} over {n_tensors} tensors")
        # the requests are the allocation's sizes: within LAUNCH_ROUND a
        # tensor of the prediction (measured: equal).  The allocator's
        # blocks round each to 512 bytes and keep a large block's tail of
        # under 1 MiB unsplit (chip run 1: 1,319,904 bytes over 43
        # tensors): printed, not held
        if abs(requested - predicted) > LAUNCH_ROUND * n_tensors:
            raise AssertionError(f"{tag}: placing the arguments requested "
                                 f"{requested} bytes, predicted {predicted}")
        log(f"[{tag}] requested - predicted {requested - predicted} bytes; "
            f"the allocator's blocks {allocated - requested} bytes above "
            f"the requests")

        def step(cell=cell):
            return cell.step(*cell.args)

        del_out = step()                      # warm: workspaces, handles
        del del_out
        torch.cuda.synchronize()
        with FlopCounterMode(display=False) as fc:
            res = step()
        del res
        card_flops = fc.get_total_flops()
        log(f"[{tag}] FLOPs predicted {rec['counts']['flops']} "
            f"({rec['counts']['flops_by_dtype']}), on the card "
            f"{card_flops}")
        if card_flops != rec["counts"]["flops"]:
            raise AssertionError(f"{tag}: {card_flops} FLOPs on the card, "
                                 f"{rec['counts']['flops']} predicted")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del res
        pred_peak = rec["memory"]["transient_bytes_ideal"]
        gap = (pred_peak - peak) / peak
        log(f"[{tag}] transient peak predicted {pred_peak!r} bytes, "
            f"measured {peak} (max_memory_allocated above the arguments): "
            f"{gap:+.2e} (limit {LAUNCH_PEAK_TOL:.0e})")
        if abs(gap) > LAUNCH_PEAK_TOL:
            raise AssertionError(f"{tag}: peak {pred_peak} predicted, {peak} "
                                 f"measured")
        ms = time_ms(step, iters=5, warmup=1)
        bound_ms = max(roof["compute_s"], roof["memory_s"],
                       roof["collective_s"]) * 1e3
        log(f"[{tag}] measured {ms!r} ms a step; roofline compute "
            f"{roof['compute_s'] * 1e3!r} ms (by dtype "
            f"{roof['flops_by_dtype']}), memory {roof['memory_s'] * 1e3!r} "
            f"ms, collective {roof['collective_s'] * 1e3!r} ms: "
            f"{roof['bottleneck']} binds, {bound_ms / ms:.4f} of the "
            f"measured time ({smi}); dry run {dry_s!r} s")
        out["cells"][tag] = {
            "resident_predicted": predicted, "requested": requested,
            "allocated": allocated, "tensors": n_tensors,
            "flops_predicted": rec["counts"]["flops"],
            "flops_by_dtype": rec["counts"]["flops_by_dtype"],
            "flops_card": card_flops, "peak_predicted": pred_peak,
            "peak_measured": peak, "peak_gap": gap, "ms": ms,
            "roofline": roof, "roofline_share": bound_ms / ms,
            "dry_run_s": dry_s}
        del cell, step
        torch.cuda.empty_cache()
    proc, t_cli = cli
    stdout, stderr = proc.communicate(timeout=300)
    cli_s = time.perf_counter() - t_cli
    if proc.returncode:
        raise AssertionError(f"launch cli: rc {proc.returncode}\n"
                             f"{stdout[-2000:]}{stderr[-2000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    recs = [json.loads(f.read_text())
            for f in LAUNCH_OUT.glob("*.smoke.json")
            if not f.name.startswith("summary")]
    log(f"[launch cli] {' '.join(LAUNCH_CLI)}: {summary}, {cli_s!r} s "
        f"from its start")
    for r in recs:
        log(f"[launch cli] {r['arch']} {r['shape']} {r['mesh']} "
            f"{r['variant']}: ok {r['ok']}, resident "
            f"{r['resident_bytes']['total'] / 2 ** 30:.3f} GiB a device, "
            f"transient (ideal) "
            f"{r['memory']['transient_bytes_ideal'] / 2 ** 30:.3f} GiB, "
            f"bottleneck {r['roofline']['bottleneck']}, {r['seconds']!r} s")
    if not summary.get("ok") or len(recs) != 2 or \
            not all(r["ok"] for r in recs):
        raise AssertionError(f"launch cli: {stdout[-2000:]}")
    out["cli"] = {"summary": summary, "seconds": cli_s,
                  "records": [{k: r[k] for k in ("arch", "shape", "mesh",
                                                 "variant", "ok", "seconds",
                                                 "resident_bytes",
                                                 "roofline")}
                              for r in recs]}
    return out


# The examples phase: the four drivers of ``repro_torch.examples`` on the
# card at their smallest flags, each in its own process, side by side;
# each one's last line is its JSON report.
EXAMPLES = (("quickstart",),
            ("serve_deit_mxint", "--requests", "16", "--batch", "8",
             "--train-steps", "20"),
            ("serve_llm_mxint", "--requests", "2", "--new-tokens", "4",
             "--kernel"),
            ("train_lm_fault_tolerant", "--steps", "4", "--batch", "2",
             "--seq", "16", "--dir", "build/examples/train_lm"))


def start_examples():
    """Start every driver; returns (the processes, the start time)."""
    return [(ex[0], child([f"repro_torch.examples.{ex[0]}", *ex[1:]]))
            for ex in EXAMPLES], time.perf_counter()


def examples_phase(started):
    """Wait for the drivers and check their reports (module docstring,
    item 22c)."""
    procs, t0 = started
    out = {}
    for name, p in procs:
        stdout, stderr = p.communicate(timeout=300)
        if p.returncode:
            raise AssertionError(f"example {name}: rc {p.returncode}\n"
                                 f"{stdout[-2000:]}{stderr[-2000:]}")
        rep = json.loads(stdout.strip().splitlines()[-1])
        out[name] = rep
        log(f"[examples] {name}: {json.dumps(rep)[:600]}")
    out["seconds"] = time.perf_counter() - t0
    deit = out["serve_deit_mxint"]
    if deit["kernel_equals_sim"] != deit["batches"] or not deit["batches"]:
        raise AssertionError(f"serve_deit_mxint: kernel == sim on "
                             f"{deit['kernel_equals_sim']} of "
                             f"{deit['batches']} batches")
    llm = out["serve_llm_mxint"]
    if not (llm["kernel"] and llm["tokens"] == 8
            and llm["launches"]["flash_attention_decode"] > 0
            and llm["launches"]["mxint_matmul"] > 0):
        raise AssertionError(f"serve_llm_mxint: {llm}")
    if not out["train_lm_fault_tolerant"]["resumed_equals_straight"]:
        raise AssertionError("train_lm_fault_tolerant: the resumed run "
                             "differs from the straight one")
    if not all(out[ex[0]]["ok"] for ex in EXAMPLES) or any(
            not out[ex[0]]["device"].startswith("cuda") for ex in EXAMPLES):
        raise AssertionError(f"examples: {out}")
    log(f"[examples] all four drivers on the card in "
        f"{out['seconds']!r} s; kernel == sim on {deit['kernel_equals_sim']}"
        f"/{deit['batches']} DeiT batches")
    return out


def check_full_depth_launches(name, stats):
    """Raise unless a serve phase launched the counts of
    ``FULL_DEPTH_LAUNCHES`` a slot prefill and a decode step."""
    got = (stats["launches_per_slot_prefill"],
           stats["launches_per_decode_step"])
    if got != FULL_DEPTH_LAUNCHES[name]:
        raise AssertionError(f"{name}: {got} launches a slot prefill and a "
                             f"decode step, not {FULL_DEPTH_LAUNCHES[name]}")


def card_vs_cpu_phases(torch, np, phase, new_lms, moe_lms, rec_lms):
    """Every LM, LLaVA and Seamless card-against-CPU check, after every
    timed phase, in the pool that ``main`` started (``CPU_CHECKS``): each
    card side runs and its CPU side goes to the pool at once, the checks
    whose CPU sides take longest first, in the order of the calls here
    (PERF.md §4 has each CPU side's seconds).  Returns the finishers of the
    Llama, LLaVA and Seamless checks and sets ``card_vs_cpu`` in the
    other models' results (finishers too)."""
    import importlib
    from repro_torch.configs import llama3_8b

    def full(name):
        return importlib.import_module(f"repro_torch.configs.{name}").FULL

    for name in MOE_LMS[:1]:
        moe_lms[name]["card_vs_cpu"] = phase(
            f"{name} card vs cpu", lm_cpu_phase, torch, np, full(name),
            ("kernel",), NEW_LM_CPU_PROMPTS, NEW_LM_CPU_SCORE, f"{name} cpu",
            MOE_CPU_LAYERS)
    for name in NEW_LMS[:1]:
        new_lms[name]["card_vs_cpu"] = phase(
            f"{name} card vs cpu", lm_cpu_phase, torch, np, full(name),
            NEW_LM_CPU_MODES, NEW_LM_CPU_PROMPTS, NEW_LM_CPU_SCORE,
            f"{name} cpu", NEW_LM_CPU_LAYERS)
    rec_lms[REC_LMS[0]]["card_vs_cpu"] = phase(
        f"{REC_LMS[0]} card vs cpu", lm_cpu_phase, torch, np,
        full(REC_LMS[0]), REC_CPU_MODES, REC_CPU_PROMPTS,
        REC_CPU_SCORE[REC_LMS[0]], f"{REC_LMS[0]} cpu", 1)
    vlm = phase("llava card vs cpu", vlm_cpu_phase, torch, np)
    lm = phase("lm card vs cpu", lm_cpu_phase, torch, np, llama3_8b.FULL,
               tuple(LM_CPU_MODES), (100, 250), 640, "lm cpu", LM_CPU_LAYERS)
    for name in REC_LMS[1:]:
        rec_lms[name]["card_vs_cpu"] = phase(
            f"{name} card vs cpu", lm_cpu_phase, torch, np, full(name),
            REC_CPU_MODES, REC_CPU_PROMPTS, REC_CPU_SCORE[name],
            f"{name} cpu", 1)
    for name in NEW_LMS[1:]:
        new_lms[name]["card_vs_cpu"] = phase(
            f"{name} card vs cpu", lm_cpu_phase, torch, np, full(name),
            NEW_LM_CPU_MODES, NEW_LM_CPU_PROMPTS, NEW_LM_CPU_SCORE,
            f"{name} cpu", NEW_LM_CPU_LAYERS)
    encdec = phase("seamless card vs cpu", encdec_cpu_phase, torch, np)
    for name in MOE_LMS[1:]:
        moe_lms[name]["card_vs_cpu"] = phase(
            f"{name} card vs cpu", lm_cpu_phase, torch, np, full(name),
            ("kernel",), NEW_LM_CPU_PROMPTS, NEW_LM_CPU_SCORE, f"{name} cpu",
            MOE_CPU_LAYERS)
    return lm, vlm, encdec


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", metavar="NAME",
                    help="build, then run only the kernel phase of these "
                         "kernels (a quick check; prints no 'ok' line)")
    ap.add_argument("--analysis", action="store_true",
                    help="build, then run only the analysis phase (prints "
                         "no 'ok' line)")
    ap.add_argument("--training", action="store_true",
                    help="build, then run only the training phases (17-20; "
                         "prints no 'ok' line)")
    ap.add_argument("--launch", action="store_true",
                    help="build, then run only the launch and examples "
                         "phases (22b-22c; prints no 'ok' line)")
    args = ap.parse_args(argv)
    import atexit
    atexit.register(_stop_children)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.kernels import _build

    # every float32 matmul (the unembedding, the plain versions) in full
    # float32: no TF32 tensor-core rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all(verbose=bool(args.kernels))
    log(f"[build] {len(_build.KERNELS)} sources built in "
        f"{time.perf_counter() - t0!r} s")
    if args.kernels:
        kernels = kernel_phase(torch, np, only=set(args.kernels))
        log(json.dumps({"partial": sorted(kernels)}))
        return 0
    if args.analysis:
        t = time.perf_counter()
        fixture, analysis = analysis_phase(torch, np)
        log(f"[time] analysis phase {time.perf_counter() - t!r} s")
        out = ROOT / "build"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_analysis.json").write_text(json.dumps(
            {"card": smi, "launch_fixture": fixture, "analysis": analysis},
            indent=1, default=str))
        log(json.dumps({"partial": ["analysis"]}))
        return 0
    if args.training:
        t = time.perf_counter()
        train = train_phase(torch, np)
        log(f"[time] train phase {time.perf_counter() - t!r} s")
        t = time.perf_counter()
        acc, _ = accuracy_phase(torch, np)
        log(f"[time] accuracy phase {time.perf_counter() - t!r} s")
        t = time.perf_counter()
        lm = lm_train_phase(torch, np)
        log(f"[time] lm train phase {time.perf_counter() - t!r} s")
        t = time.perf_counter()
        rec = rec_train_phase(torch, np)
        log(f"[time] rec train phase {time.perf_counter() - t!r} s")
        out = ROOT / "build"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_training.json").write_text(json.dumps(
            {"card": smi, "train": train, "accuracy": acc, "lm_train": lm,
             "rec_train": rec}, indent=1))
        log(json.dumps({"partial": ["train", "accuracy", "lm train",
                                    "rec train"]}))
        return 0

    if args.launch:
        t = time.perf_counter()
        launch = launch_phase(torch, np, smi, start_launch_cli())
        log(f"[time] launch phase {time.perf_counter() - t!r} s")
        t = time.perf_counter()
        examples = examples_phase(start_examples())
        log(f"[time] examples phase {time.perf_counter() - t!r} s")
        out = ROOT / "build"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_launch.json").write_text(json.dumps(
            {"card": smi, "launch": launch, "examples": examples}, indent=1,
            default=str))
        log(json.dumps({"partial": ["launch", "examples"]}))
        return 0

    t_start = time.perf_counter()

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log(f"[time] {name} phase {time.perf_counter() - t!r} s, "
            f"{time.perf_counter() - t_start!r} s since the build")
        return out

    import importlib
    from repro_torch.configs import llama3_8b
    fixture, analysis = phase("analysis", analysis_phase, torch, np)
    kernels = phase("kernel", kernel_phase, torch, np)
    kernels["launch_fixture"] = fixture
    stats, launches = phase("deit", slice_phase, torch, np)
    model, engine, lm_stats = phase(
        "lm serve", lm_serve_phase, torch, np, llama3_8b.FULL, LM_PROMPTS,
        LM_NEW_TOKENS, "lm serve")
    check_full_depth_launches("llama3_8b", lm_stats)
    score_stats, score_launches = phase("lm score", lm_score_phase, torch,
                                        np, model, engine)
    del model, engine
    torch.cuda.empty_cache()
    backend_stats, mixed_launches = phase("backends", backends_phase, torch,
                                          np)
    probe_stats = phase("probes", probes_phase, smi)
    dse_stats, dse_launches = phase("dse", dse_phase, torch, np)
    widened_stats, widened_launches, widened_routes = phase(
        "widened serve", widened_serve_phase, torch, np)
    wide_lm_stats, wide_lm_launches, wide_lm_routes = phase(
        "widened lm", widened_lm_phase, torch, np)
    new_lms = {}
    for name in NEW_LMS:
        full = importlib.import_module(f"repro_torch.configs.{name}").FULL
        model, engine, serve = phase(
            f"{name} serve", lm_serve_phase, torch, np, full, NEW_LM_PROMPTS,
            NEW_LM_NEW_TOKENS, name)
        check_full_depth_launches(name, serve)
        del model, engine
        torch.cuda.empty_cache()
        new_lms[name] = {"serve": serve}
    moe_lms = moe_phases(torch, np, phase)
    ds_full = cut_depth(
        importlib.import_module("repro_torch.configs.deepseek_67b").FULL,
        DEEPSEEK_LAYERS)
    model, engine, ds_serve = phase("deepseek_67b serve", lm_serve_phase,
                                    torch, np, ds_full, NEW_LM_PROMPTS,
                                    NEW_LM_NEW_TOKENS, "deepseek_67b")
    check_full_depth_launches("deepseek_67b", ds_serve)
    del model, engine
    torch.cuda.empty_cache()
    rec_lms = recurrent_phases(torch, np, phase)
    vlm_stats = phase("llava", vlm_phase, torch, np)
    encdec_stats = phase("seamless", encdec_phase, torch, np)
    train_stats = phase("train", train_phase, torch, np)
    acc_stats, acc_launches = phase("accuracy", accuracy_phase, torch, np)
    lm_train_stats = phase("lm train", lm_train_phase, torch, np)
    rec_train_stats = phase("rec train", rec_train_phase, torch, np)
    # the pool of the CPU sides: its workers start with the first job, the
    # tp phase's, which is added after that phase's timed parts
    workers = os.cpu_count() or 1
    log(f"[cpu checks] the pool: {workers} worker processes "
        f"(os.cpu_count()), {CPU_THREADS} torch thread each")
    # the example drivers side by side, before the pool: beside it they
    # took the cores its CPU sides need (chip run 5: the drivers 119 s,
    # the pool 447 s)
    examples_stats = phase("examples", examples_phase, start_examples())
    CPU_CHECKS.start(workers)
    # the dry run's CLI needs no card and the pool is idle yet: it runs
    # beside the tp phase
    launch_cli = start_launch_cli()
    tp_stats, tp_cpu, tp_launches = phase("tp", tp_phase, torch, np, smi)
    # every timed phase is done: the card-against-CPU checks, their CPU
    # sides side by side in the pool, and each check compares
    cpu_stats, vlm_cpu, encdec_cpu = card_vs_cpu_phases(
        torch, np, phase, new_lms, moe_lms, rec_lms)
    widened_cpu = phase("widened card vs cpu", widened_cpu_phase, torch, np)
    # the card is free while the pool works: the launch dry run against
    # the card
    torch.cuda.empty_cache()
    launch_stats = phase("launch", launch_phase, torch, np, smi, launch_cli)
    phase("cpu checks", CPU_CHECKS.run)
    log(f"[cpu checks] {len(CPU_CHECKS.futures)} CPU sides, "
        f"{CPU_CHECKS.seconds!r} s from the pool's start")
    cpu_stats, vlm_cpu, encdec_cpu = cpu_stats(), vlm_cpu(), encdec_cpu()
    widened_stats["card_vs_cpu"] = widened_cpu()
    tp_stats["card_vs_cpu"] = tp_cpu()
    for res in (*new_lms.values(), *moe_lms.values(), *rec_lms.values()):
        res["card_vs_cpu"] = res["card_vs_cpu"]()
    common = ("mxint_ln_matmul", "mxint_matmul", "mxint_gelu",
              "mxint_layernorm")
    paths = (("analysis", analysis["launches"],
              common + ("mxint_softmax", "flash_attention_decode",
                        "launch_fixture")),
             ("deit serve", launches, common + ("mxint_softmax",)),
             ("lm serve", lm_stats["launches"],
              common + ("flash_attention_decode",)),
             ("lm score", score_launches, common + ("flash_attention",)),
             ("deit mixed", mixed_launches, ("mxint_ln_matmul",
                                             "mxint_matmul", "mxint_softmax",
                                             "mxint_layernorm")),
             ("dse", dse_launches, common + ("mxint_softmax",)),
             ("deit widened acts", widened_launches,
              common + ("mxint_softmax",)),
             # the served widened formats: the row kernels' generic
             # routes (W12, act block 12, the vanilla LUTs; its GEMMs on
             # the core) and the GEMMs' (17-bit acts); the widened LM: the
             # flash kernels' generic routes
             ("deit widened generic routes", widened_routes,
              tuple(f"{n}/generic" for n in common + ("mxint_softmax",))),
             ("llama widened lm", wide_lm_launches,
              common + ("flash_attention", "flash_attention_decode")),
             ("llama widened lm generic routes", wide_lm_routes,
              ("flash_attention/generic",
               "flash_attention_decode/generic"))) + tuple(
        (f"{name} serve", res["serve"]["launches"],
         common + ("flash_attention_decode",))
        for name, res in new_lms.items()) + tuple(
        (f"{name} {what}", res[what]["launches"],
         common + ("mxint_softmax", attn))
        for name, res in moe_lms.items()
        for what, attn in (("serve", "flash_attention_decode"),
                           ("score", "flash_attention"))) + (
        ("deepseek_67b serve", ds_serve["launches"],
         common + ("flash_attention_decode",)),
        ("accuracy kernel mode", acc_launches, common + ("mxint_softmax",)),
        # RecurrentGemma: a prefill's attention is float, the decode
        # kernel runs in every step, the flash kernel in the 1024-token
        # score, the whole-row softmax in the 512-token one; xLSTM has no
        # attention, no FFN and no GELU
        ("recurrentgemma_2b serve", rec_lms["recurrentgemma_2b"]["serve"][
            "launches"], common + ("flash_attention_decode",)),
        ("recurrentgemma_2b score", rec_lms["recurrentgemma_2b"]["score"][
            "launches"], common + ("flash_attention",)),
        ("recurrentgemma_2b score 512", rec_lms["recurrentgemma_2b"][
            "score_softmax"]["launches"], common + ("mxint_softmax",)),
        ("xlstm_350m serve", rec_lms["xlstm_350m"]["serve"]["launches"],
         ("mxint_matmul", "mxint_layernorm")),
        ("xlstm_350m score", rec_lms["xlstm_350m"]["score"]["launches"],
         ("mxint_matmul", "mxint_layernorm")),
        # LLaVA: the projector and the layers' linears, the decode kernel
        # in every step, the flash kernel in the 3072-position score;
        # Seamless: no fused norm -> linear; the encoder's flash kernel at
        # 1024 frames, its whole-row softmax at 256, the cross-attention's
        # whole-row softmax and the decode kernel in every step
        ("tp column stream, rank 0", tp_launches, common +
         ("mxint_softmax",)),
        ("llava serve", vlm_stats["launches"],
         common + ("flash_attention_decode",)),
        ("llava score", vlm_stats["score"]["launches"],
         common + ("flash_attention",)),
        (f"seamless serve {ENCDEC_FRAMES}",
         encdec_stats[f"serve_{ENCDEC_FRAMES}"]["launches"],
         ("mxint_matmul", "mxint_gelu", "mxint_layernorm", "mxint_softmax",
          "flash_attention", "flash_attention_decode")),
        (f"seamless serve {ENCDEC_SHORT_FRAMES}",
         encdec_stats[f"serve_{ENCDEC_SHORT_FRAMES}"]["launches"],
         ("mxint_matmul", "mxint_gelu", "mxint_layernorm", "mxint_softmax",
          "flash_attention_decode")))
    for path, counts, names in paths:
        idle = [n for n in names if not counts[n]]
        if idle:
            raise AssertionError(f"{path}: {idle} never launched")
    # a kernel's ``launches`` count its fast route's, ``<kernel>/generic``
    # its generic route's (the paths' generic-route counts)
    for name, res in kernels.items():
        res["launches"] = sum(counts.get(name, 0) - counts.get(
            f"{name}/generic", 0) for _, counts, _ in paths)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": kernels, "slice": stats, "lm_serve": lm_stats,
         "lm_score": score_stats, "lm_card_vs_cpu": cpu_stats,
         "backends": backend_stats, "probes": probe_stats, "dse": dse_stats,
         "widened_serve": widened_stats, "widened_lm": wide_lm_stats,
         **new_lms, **moe_lms,
         "deepseek_67b": {"serve": ds_serve}, **rec_lms,
         "llava_next_mistral_7b": {**vlm_stats, "card_vs_cpu": vlm_cpu},
         "seamless_m4t_medium": {**encdec_stats, "card_vs_cpu": encdec_cpu},
         "train": train_stats,
         "accuracy": acc_stats, "lm_train": lm_train_stats,
         "rec_train": rec_train_stats, "tp": tp_stats,
         "launch": launch_stats, "examples": examples_stats,
         "analysis": analysis, "cpu_checks_s": CPU_CHECKS.seconds},
        indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
