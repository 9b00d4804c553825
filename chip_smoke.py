#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build     — compile every CUDA source of the port with nvcc (sm_90a);
2. kernels   — hold each of the twelve kernels against its plain PyTorch
               version on the card, at its main path's shapes (HPL:
               m = 16384, b = 64; transpose_add 16384^2; STREAM 2^28
               elements; matmul 8192^3; flash_attention at the serving
               prefill, q 8x1024x24x128, k/v 8x1024x8x128, bf16, causal,
               on its tensor-core route, and the same shape in fp32 on its
               SIMT route; HPL's LU, Top- and Left-panel kernels also
               on their routes at the ragged 48 (strided), at 128 and on
               strided panels of prime width (Top) or height (Left) 1009,
               the Left panel at HPL's layout (a column strip, row stride
               16384), and their output bits against LU_BITS (the first
               port's kernels'); gemm_update timed against torch.addmm
               in STREAM_ROUNDS alternated rounds, also at HPL's trailing
               views (GEMM_TRAILING, row stride 16384) and the lookahead's
               64 x 16384 and 16384 x 64 strips (the row's ``shapes``),
               and its output bits against GEMM_BITS (the first port's
               kernel's) at those shapes and a ragged view, all on its
               ``simt_f32`` route; in bf16 on its ``wgmma_bf16`` route
               (tensor cores): within the plain version's limit, two runs
               bit-identical, HPL's 64 x 16384 and 16384 x 64 strips each
               bit-identical to the full update's rows and columns, its
               bits against GEMM_BITS (as that route first gave them), and
               timed against torch.addmm in bf16;
               the LU family timed queued behind a sleep kernel
               (device time; back-to-back events time the host's wrapper
               at a few microseconds a call); ring_add_step at the largest
               per-hop chunk of
               the allreduce phase, 6,291,456 fp32, and at 2^21 (a 32 MiB
               bucket's chunk), 2^28 fp32 and bf16, aliased, misaligned, and
               ragged in fp32 and fp16; its device time alone, queued
               behind a sleep kernel, at every hop chunk of the allreduce
               phase and at 2^21) and at ragged and strided shapes and in
               bf16, and time kernel, plain version and the nearest PyTorch
               library call (fp32 library calls run with TF32 off; the
               STREAM ops and their library calls in STREAM_ROUNDS
               alternated rounds, medians, with their share of the HBM
               rate).
               matmul's limit is fp32 rounding, which a TF32 product and a
               dropped K step both exceed, and its sums must equal
               gemm_update's order (C = 0 + 1 * A @ B) exactly;
               flash_attention's limit (tests/test_kernels.py: atol 8e-2
               bf16, 2e-4 fp32, rtol 2e-2) refuses the kernel with its
               causal mask off and with the wrong kv head, and in bf16 it is
               also held within one bf16 ulp of |want| plus 1e-3, which
               refuses a kernel that drops the last q tile's diagonal kv
               tile, or only the last query's own key (a fault small enough
               to pass the reference limit), or shifts the mask by one key
               in the late rows; the run shows that they do. Every bf16
               flash call must launch on the ``wgmma_bf16`` route, every
               fp32 one on ``simt_f32``; the bf16 cases include the
               prefill shapes of phases moe (q 64 heads on 4 kv heads), ssm
               (4 heads of 128) and vlm (64 heads on 8); flash's TFLOP/s
               and its share of
               the bf16 tensor-core bound are printed;
3. hpl       — ``run_hpl`` on the 1x1 grid at n = 16384, b = 64: residual
               < 1 (and whether it equals HPL_RESIDUAL), GFLOP/s, and each
               HPL kernel launched nb = 256 times per factorization, the LU
               and both panels every time on HPL_ROUTES' routes;
4. lookahead — depths 1 and 2 at n = 4096 equal eager bit for bit, with the
               launch counts (and routes) the pipeline implies;
5. ptrans    — ``run_ptrans`` on the 1x1 grid at n = 16384, b = 128: error
               0.0 against B + A^T on the host, one transpose_add per step;
               ``nchunks=4`` (four launches per step) equals ``nchunks=1``
               bit for bit;
6. beff      — ``run_beff`` on the single-rank ring (max_log = 20,
               rounds = 4): byte check passes, buffers on the card. There is
               no wire: its bandwidth is the host's loop overhead;
7. stream    — ``run_stream`` at 2^28 fp32 elements per array (1 GiB, 21x
               the 50 MB L2): the four bandwidths, their share of the HBM
               rate, and every op equal to its plain version;
8. gemm      — ``run_gemm`` at m = 8192: GFLOP/s, error against
               ``torch.matmul`` with TF32 off, within fp32 rounding;
9. cpu       — the card's LU at n = 2048 against the port's plain CPU LU;
10. serve    — llama3.2-3b at full width and depth (28 layers, random
               weights from seed 0): ``generate`` on the one-rank mesh, 8
               requests x 1024 prompt tokens, 32 new tokens, greedy: 28
               flash launches in the prefill, all on ``wgmma_bf16``, and
               none in decode, output
               (8, 1056) keeping the prompts, two runs bit-identical; the
               prefill and decode steps timed apart (prompt tokens/s, decode
               ms per step p50, generated tokens/s, peak memory); and an
               fp32 prefill (B = 1, S = 1024) through flash (28 launches
               on ``simt_f32``) against the same prefill through the plain
               ``attention`` (``mesh=None``), within FP32_PREFILL_ATOL,
               which the bf16 prefill's logits exceed;
11. allreduce — four processes on the one card, a gloo ring that stages
               every payload through host memory, each holding the gradient
               of one llama3.2-3b decoder layer at full width (9 fp32
               leaves, 100.7 M elements, 403 MB) on the card: every
               allreduce schedule's ``allreduce_tree`` (the cost model's
               buckets, ``bucket_bytes_for``: 16 MiB on a ring of four from
               the H100 model's loopback constants, checked against
               ``derive_bucket_bytes``) bit for bit against the sum of the four
               ranks' integer-valued trees on every rank (int8_ef on
               block-representable ones), rs_ag also in one bucket, a
               quarter-tree bucket and one leaf per bucket; then normal
               leaves through rs_ag, bit for bit across the ranks and
               against a replay of the ring's order of additions with the
               plain ``ring_add_step``, launching the kernel 3 times per
               bucket with a nonempty chunk, as counted from
               ``pack_buckets``. Its times are the host's loopback,
               not a link rate.

12. gups    — RandomAccess at table_log = 28 (a 1 GiB int32 table, 20x
               the L2) with 2^18 generators x 4096 updates (2^30 updates,
               HPCC's 4 per table word) on one rank: ``run_randomaccess``
               and ``run_randomaccess_dist`` restore exactly (error 0), the
               two forward tables are bit-identical, and the card's streams
               of the first 64 generators equal the CPU's; GUPS, a step's
               seconds by phase (generate / bucket / exchange / scatter)
               and peak memory. No hand kernel runs: the scatter is
               ``index_add_``, as the reference leaves it to XLA;
13. fft      — ``run_fft`` and ``run_fft_dist`` on 2^15 signals of 4096
               complex64 (1 GiB) on one rank: error < 1e-5 against the
               complex128 transform, the pencil step bit-identical to the
               local one, GFLOP/s (5 n log2 n per signal) and cuFFT's
               device time against its byte bound;
14. a2a      — four processes sharing the card over gloo, as allreduce:
               routed GUPS (table_log = 22, 2^10 generators x 4096 a rank)
               and the pencil FFT (1024 signals of 4096 a rank) for every
               ``all_to_all_tiles`` schedule with nchunks 1 and 4: restore
               exact, received buckets and tables identical across
               schedules, FFT bit-identical to ``torch.fft.fft`` at the
               per-rank block shape (B/4, n), bytes staged per rank.
15. autotune — the cost model and autotuner (``comm/autotune.py``):
               ``run_hpl`` at n = 16384, b = 64 with ``lookahead="auto"``
               (the depth ``choose_hpl_depth`` gives on the H100 model),
               residual < 1, the launches its depth implies, and the LU
               bit for bit that of its integer depth and of eager; the
               one-card section of ``hpl_scaling`` (quick); the loopback's
               link constants on four gloo processes
               (``hw_model.link_constants``) beside the model's; and the
               quick measured ``autotune_mesh`` on a ring (and a 2x2 torus)
               of four processes with the ``--autotune`` gate, which fails
               unless every registered exact schedule was timed at both
               sizes; its table goes to a temporary directory, so the
               checkout's ``results/tuning_torch.json`` and the default
               model stay as they were. Prints the H100 model, the
               table's bands, the depth, the bucket and its seconds.
16. faults  — the fault layer (``comm/faults.py``, ``comm/retune.py``)
               on four processes sharing the card over gloo, payloads on
               the card, 1 MiB per rank: the link-down section of
               ``failover_bench`` (hop 3 of the ring hard-down; bcast and
               allreduce resolve ring2d -> staged -> ring2d on the H100
               model, routes that avoid the cut, outputs bit-identical
               across the phases and equal to x[0] and x.sum(0), every
               rank alike; the float allreduce launches ``ring_add_step``
               3 times per rank on ring2d and never on staged) and the
               train-retune section of ``resilience_bench`` (hpl.panel
               flips ring2d -> staged at step 8 and back at step 20, detect
               delays in [0, 6], identical traces on every rank, the bcast
               bit-identical), both gates asserted; then the measured
               retune's quick ladder (``bcast@hpl.panel`` at 1 MiB, clean
               and under an injector) from this process, which launches no
               kernel in the phase. Prints the resolutions, routes, reroute
               latency, retune events and the phase's seconds, all the
               host's loopback, not a link rate.
17. moe     — qwen3-moe-235b-a22b at full width, depth cut to MOE_LAYERS
               (random weights from seed 0, drawn in fp32 and cast to bf16,
               the fp32 draw freed): ``generate`` on the one-rank mesh as
               in serve, 8 x 1024 prompts, 32 new greedy tokens; one flash
               launch a layer per prefill, all on ``wgmma_bf16`` (q 64 heads, k/v
               4: a GQA group of 16), none in decode, output (8, 1056)
               keeping the prompts, two runs bit-identical; prefill s,
               prompt tokens/s, decode ms per step p50, generated tokens/s,
               peak memory, and each layer's prefill ``moe_dropped``
               (equal to a recount from the routing's per-row histogram)
               beside its input's common share (rms of the token mean over
               the rms); the
               MoE layer alone at full width (D 4096, E 128, k 8, F 1536),
               B = 1, S = 256, fp32, capacity C = S (nothing dropped),
               against ``reference_moe`` within rtol 1e-4, atol 1e-5; then
               four processes sharing the card on a gloo ring, one
               full-width fp32 layer with 32 experts and one 256-token row
               per rank: the expert-parallel layer for every
               ``all_to_all_tiles`` schedule x nchunks 1, 2 equal to the
               single-process ``apply_moe`` within the same limits, bit-
               identical across schedules and chunk counts, staging exactly
               2x/3x/5x the two exchanges' payload per rank (printed).
18. ssm     — mamba2-130m at full size (24 layers, no attention: no
               flash launch) and jamba cut to 4 layers at d_model 512 in
               bf16 (SSM, attention, SSM, attention; MoE every 2nd layer;
               head_dim 128; labelled reduced: one full-width jamba MoE
               layer is 19.3 GB of bf16 experts), each served as in serve:
               flash launches per prefill equal to the attention layers,
               two runs bit-identical, and the same times.
19. vlm     — llama-3.2-vision-90b at full width, depth cut to one period
               of 5 layers (the cross layer last; 5.47e9 parameters, drawn
               in fp32 and cast to bf16), its cross gates drawn from
               VLM_GATE_SEED (the reference's start at 0 and hide the cross
               branch), served as in serve with 1024 patches x 1280 a
               request: 5 flash launches per prefill, all ``wgmma_bf16``,
               none for the cross layer or in decode, output (8, 1056)
               keeping the prompts, two runs bit-identical; an fp32
               batch-1 prefill of VLM_WITNESS_S tokens and 1024 patches on
               the card against the same call on the CPU within FP32_TOL;
               one request's logits must move when the gates close; the
               times, the init and serving peaks, and the TFLOP each decode
               step spends recomputing the cross K/V from the patches.
20. whisper — whisper-base at full size, 8 requests of 1500 frames and 64
               prompt tokens, 32 new: no flash launch (no path of the
               encoder-decoder takes it, as in the reference), two runs
               bit-identical, the times; then an fp32 batch-1 prefill on
               the card against the same call on the CPU within
               FP32_TOL (the cpu phase's limit).
21. engine  — the continuous-batching ``ServeEngine`` on llama3.2-3b at
               full size in bf16: 16 requests of 512-1024 prompt tokens
               (numpy seed ENGINE_SEED), 32 new, pages of 16 tokens, 8
               slots, a pool of 8 x 66 pages, run twice: every request
               returns its prompt and 32 tokens, the runs bit-identical, no
               kernel launched (the engine's prefill has no mesh, C7);
               generated tokens/s, decode-step p50/p99, prefill seconds per
               request, peak memory. Before them, the paged decode's
               witness: the same requests through an fp32 engine, every
               decode step's logits row of every active slot against the
               dense model's logits (one forward without a cache over
               the request's final sequence) within FP32_TOL, over steps
               with inactive (sentinel) slots, reused pages and tokens
               that fill their last page. Then ``resilience_bench``'s serve-
               degradation section on the card with its gate: a 4-page pool
               under a ``serve.step`` delay, token-identical to a 16-page
               pool, no token lost, at least one preemption.
22. train   — llama3.2-3b at full size (3.21e9 parameters, random weights
               from seed 0) trained TRAIN_STEPS steps through
               ``make_train_step``: bf16 compute over fp32 master weights
               and AdamW moments, remat "full", the port's synthetic data
               at 4 x 1024 tokens a step, TRAIN_WARMUP warmup steps. Every
               loss finite, the last below the first; a second run of the
               first TRAIN_REPEAT steps gives the same losses and weights
               bit for bit (the phase runs in a process of its own under
               ``torch.use_deterministic_algorithms``, cuBLAS with the
               fixed workspace CUBLAS_WORKSPACE_CONFIG=:4096:8, set before
               CUDA starts there, so that no other phase's cuBLAS runs
               with it); no hand kernel launched (training takes the
               plain attention: the reference's flash kernel has no VJP).
               Prints each loss, the median step seconds after the first,
               tokens/s and the peak memory beside the card's name and
               power limit. Then a reduced fp32 llama's two steps on the
               card against the same steps on the CPU within
               TRAIN_WITNESS_TOL, and ``resilience_bench``'s
               train-degradation section on the card with its gate (a
               flag inside the delay window, an off-cadence checkpoint).
23. dp      — four processes sharing the card over gloo run
               ``make_dp_train_step_explicit`` for DP_STEPS steps on
               llama3.2-3b cut to DP_LAYERS layers at d_model 1024 and a
               vocab of 32768 (44.0e6 parameters), 8 x 256 tokens a step,
               for each
               of DP_SCHEDULES (``auto`` prints what it resolves): the
               losses agree across schedules and with the one-rank step on
               the global batch within DP_RTOL, every grad norm within
               DP_GN_RTOL of the one-rank step's (int8_ef's first only,
               within DP_INT8_GN_RTOL);
               native and rs_ag leave the ranks' weights bit-identical and
               within DP_WEIGHT_ATOL of the one-rank step's (chain's
               bit-identity is printed);
               int8_ef's loss and error tree are finite and its ranks
               agree; ``ring_add_step`` runs on every rank on rs_ag and
               int8_ef (and auto when it resolves to a ring), never on
               native or chain.
24. whole   — four processes sharing the card over gloo run
               ``make_whole_model_train_step_explicit`` (the tp and sp
               attention exchanges through the engine's differentiable
               all_to_all_tiles and ring_exchange) on llama3.2-3b at full
               width cut to WHOLE_LAYERS layer in fp32 (495e6 parameters),
               remat "full", WHOLE_STEPS steps of WHOLE_B x WHOLE_S tokens
               for each leg of WHOLE_LEGS, against the one-rank step on the
               global batch within WHOLE_TOL (the weights of the WHOLE_SAVED
               legs come back through ``checkpoint.save`` into a temporary
               directory, restored and compared one leg at a time, tp
               against sp too); ``ring_add_step`` 3 times per nonempty
               bucket plus 3 per step per rank on rs_ag, never on native;
               the step seconds, bytes staged by callsite and peak memory
               per rank; then qwen3-moe's ``tiny(4, layers=2)`` for each
               mode x nchunks 1, "auto" to the same gates, and
               ``failover_bench``'s rank-loss section with its gate (the
               ring shrinks 4 -> 2, the resumed losses equal the snapshot
               control's bit for bit).
25. gspmd   — four processes sharing the card over gloo, on a 2x2
               ``('data', 'model')`` mesh (``launch/mesh.py::make_mesh``):
               ``make_train_step`` on the GSPMD placement (weights split
               over ``model`` by name, moments over ``data`` too, the
               collectives engine calls on ``native``) for llama3.2-3b at
               full width cut to GSPMD_LAYERS layers in fp32, remat
               "full", WHOLE_STEPS steps of WHOLE_B x WHOLE_S tokens, with
               ZeRO-1 and then with ``fsdp``, against the one-rank step on
               the global batch within WHOLE_TOL (weights back through
               ``checkpoint.save``, gathered whole by ``gather_params``); no
               kernel launched. Then an fp32 prefill of GSPMD_PREFILL_B x
               1024 prompts on the 2x2 mesh through the flash kernel on
               each rank's 12 q heads and 4 KV heads (``simt_f32``)
               against the one-rank fp32 prefill of the rank's rows
               through the plain attention within FP32_PREFILL_ATOL; a
               bf16 ``generate`` of SERVE_B x SERVE_S prompts and
               SERVE_NEW tokens on the 2x2 mesh: per rank per prefill one
               flash launch per layer, all on ``wgmma_bf16``, none in
               decode, two runs bit-identical, the prompts kept, the
               prefill's logits against the one-rank bf16 prefill through
               the plain attention within the bf16 flash limit (atol
               FLASH_ATOL + rtol FLASH_RTOL |want|), the
               prefill seconds and decode p50 (bound by the host's
               loopback); phase kernels holds the flash kernel to its
               plain version at a rank's shapes there. Then on the ring
               ``('x',)`` of four the reduced qwen3-moe GSPMD step
               (``tiny(4, layers=2)``, whole weights, moments over
               ``x``) against the one-rank step, and
               ``lm_step_bench``'s ``moe_explicit`` section: the explicit
               layer within MOE_TOL of the GSPMD one.
26. gspmd_families — the MoE, SSM, vlm and encoder-decoder families on the
               GSPMD placement: four processes sharing the card over gloo,
               the 2x2 mesh, every result against the one-rank result on
               the same weights. ``make_train_step`` with ZeRO-1 and with
               ``fsdp`` (WHOLE_TOL, no kernel launched) for qwen3-moe's
               ``tiny(4, layers=2)`` and jamba reduced to 4 layers (a
               full-width expert layer is 9.7 GB of fp32 a process before
               its moments), mamba2-130m at full size (4 x 1024 tokens)
               and whisper-base at full size (8 x 64 tokens of 1500
               frames). qwen3-moe at full width cut to FAM_DIMS
               ``moe_layers`` layer (32 q heads, 2 KV heads and 64 experts
               a rank; the whole weights drawn by one rank at a time): its
               fp32 prefill of 4 x 1024 through flash (``simt_f32``)
               within FP32_PREFILL_ATOL of the one-rank plain prefill, each
               MoE layer's drops equal to it; the fp32 paged decode step
               from identical pages within SERVE_MESH_ATOL; a bf16
               ``generate`` of SERVE_B x SERVE_S + SERVE_NEW to phase
               gspmd's serving gates, one ``wgmma_bf16`` flash launch a
               rank a prefill and none in decode, except that its bf16
               prefill needs only FAM_MOE_BF16_WITHIN of its positions
               within the bf16 flash limit of the one-rank plain
               prefill's (bf16 routing flips near ties; the fp32 prefill
               holds the function). mamba2-130m (12 heads a rank): the
               fp32 prefill of 4 x 1024 and FAM_DIMS ``ssm_decode``
               decode steps against one rank, no flash.
               llama-3.2-vision-90b at full width cut to VLM_LAYERS,
               bf16, gates opened: the prefill of 4 x 1024 with 1024
               patches, one flash launch a self-attention layer a rank,
               within FAM_VLM_BF16_SHARE times the bf16 flash limit of
               the one-rank plain prefill, and beyond it with the gates
               closed. whisper-base (4 heads a rank): the fp32 prefill,
               no flash. Every leg's prefill is ``gspmd_prefill``, phase
               gspmd's. The weights of the train legs of
               FAM_TINY_GRAD_LEGS are held where the one-rank gradient
               reached FAM_TINY_GRAD, their first moments everywhere
               (FAM_MU_ATOL). Each leg's seconds on the summary line.
27. serve_mesh — the explicit half of serving on four processes sharing
               the card over gloo. This process first runs the one-rank
               oracles and frees them: qwen3-moe at full width cut to
               SERVE_MESH_MOE_LAYERS layer in fp32, its paged decode of
               SERVE_MESH_SLOTS slots (prompts of ENGINE_PROMPT tokens
               committed from the dense prefill, pages of ENGINE_PAGE)
               over SERVE_MESH_STEPS steps; and the one-rank fp32
               ``ServeEngine`` of llama3.2-3b at full width cut to
               SERVE_MESH_LAYERS layers on phase engine's workload,
               recording each decode's top-2 logit gap. Then every rank:
               the explicit decode step (``make_decode_step_explicit``,
               6 q and 2 KV heads a rank) on every registered
               ``all_to_all_tiles`` schedule and on auto against the
               one-rank paged step from identical pages (logits of its
               rows and its pool's KV share within SERVE_MESH_ATOL; ms a
               token, bytes staged by callsite); the explicit and the
               2x2 GSPMD ``ServeEngine`` in fp32, streams token-identical
               to the one-rank engine's or diverging first at a near-tie
               (top-2 gap below SERVE_MESH_ATOL, printed); the explicit
               engine in bf16, timed (informational: the loopback); the
               MoE step, each rank drawing the layer whole in turn and
               keeping its 32 experts, against the oracle, with 0 routed
               slots dropped; no kernel launched in any decode or engine
               leg. Then ``failover_bench``'s serve rank loss with its
               gate (GSPMD engine on a ring of four, rank 3 lost at step
               3: token-identical, 0 lost, >= 1 drained).
28. launch   — the entry points a user starts, each a process of its own
               on the card: ``python -m repro_torch.launch.train`` with
               LAUNCH_ARGS (llama3.2-3b at full size, phase train's
               geometry, 3 steps): losses finite and falling, the
               parameter count LAUNCH_PARAMS, no kernel launched, and its
               losses within LAUNCH_LOSS_RTOL of a direct ``train_loop`` on
               configs written out from the flags by hand, while a run at
               twice the rate lies outside that limit (the gate can fail);
               median step, tokens/s, peak memory and MFU against the bf16
               peak. Then ``examples.hpcc_suite`` (every row's gate; each
               row's kernel launches equal to what its sizes imply, the
               sums printed on the ``kernels`` line as
               ``launches_hpcc_suite``), ``quickstart``, ``serve_lm`` twice
               (the same greedy tokens) and ``train_lm`` for
               LAUNCH_TRAIN_LM_STEPS steps, side by side; and from the
               phase's start ``launch.dryrun`` of LAUNCH_DRYRUN (status
               ok, fits 80 GB, its record on a line; counts, not
               measurements).

Each main-path phase zeroes the launch counts just before it runs and reads
them just after (the allreduce, dp, whole, gspmd, gspmd_families and
serve_mesh phases in
each rank's process, around each ``allreduce_tree``, each schedule's or
each leg's steps;
``ring_add_step``'s launches in the summary line add rank 0's dp and whole
launches to the allreduce phase's). Then the card's ``nvidia-smi`` name and power limit, the
per-kernel summary line ``{"kernels": [...]}`` (each kernel's launches from
the phase that drives it), and last ``{"ok": true, "device": ...}``. Any
failed check raises and the script exits non-zero. Without a CUDA device,
or without the repository's ``src/repro_torch`` beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN, B_MAIN = 16384, 64
# the route each redesigned HPL kernel takes at b = 64, on every launch
HPL_ROUTES = {"lu_factor_block": "warp_regs", "trsm_lower_left": "regs64",
              "trsm_upper_right": "regs64"}
# HPL's residual at N_MAIN, B_MAIN with the first port's kernels, whose
# bits every route keeps (reported, not required: it also rests on the
# host's arithmetic)
HPL_RESIDUAL = 0.0013926777755841613
N_LOOKAHEAD = 4096
N_CPU = 2048
N_PTRANS, B_PTRANS = 16384, 128
STREAM_ELEMS = 1 << 28
STREAM_ROUNDS = 7  # alternated rounds of kernel and library call
M_GEMM = 8192
# the serving path: llama3.2-3b, 8 requests x 1024 prompt tokens, 32 new
SERVE_ARCH, SERVE_B, SERVE_S, SERVE_NEW = "llama3.2-3b", 8, 1024, 32
# the allreduce path: one layer of SERVE_ARCH's gradient on a ring of four
# processes sharing the card
ALLREDUCE_RANKS, ALLREDUCE_TIMEOUT = 4, 600.0
# RandomAccess and FFT on one rank at full size (the reference's
# rngs_per_device x updates_per_rng default scaled to 2^30 updates)
GUPS_TABLE_LOG, GUPS_RNGS, GUPS_UPDATES = 28, 1 << 18, 4096
FFT_LOG, FFT_BATCH = 12, 1 << 15
# the exchange path on four processes sharing the card, cut in depth
A2A_RANKS, A2A_TIMEOUT, A2A_CHUNKS = 4, 600.0, (1, 4)
A2A_TABLE_LOG, A2A_RNGS, A2A_FFT_BATCH = 22, 1 << 10, 1024
# the cost model's path: the link probe and the quick autotune on gloo
# worlds of four processes sharing the card, each world bounded
AUTOTUNE_TIMEOUT = 300.0
# the fault layer's path: one gloo world of four processes sharing the card
# for the link-down and train-retune sections (the measured retune's two
# torus worlds are bounded by resilience_bench.TIMEOUT)
FAULTS_TIMEOUT = 300.0
# the MoE path: qwen3-moe at full width, depth cut to MOE_LAYERS (94 layers
# are 470 GB of bf16 weights), served as SERVE_ARCH is; its layer alone at
# B = 1, S = MOE_LAYER_S in fp32 with a capacity factor that drops nothing
# (C = S), against the dense oracle; and the expert-parallel layer on
# MOE_EP_RANKS processes sharing the card, one MOE_LAYER_S-token row each
MOE_ARCH, MOE_LAYERS, MOE_LAYER_S = "qwen3-moe-235b-a22b", 4, 256
MOE_EP_RANKS, MOE_EP_TIMEOUT, MOE_EP_CHUNKS = 4, 600.0, (1, 2)
MOE_TOL = (1e-4, 1e-5)  # rtol, atol: tests/dist/test_moe.py
# the SSM path: mamba2-130m at full size, and jamba cut to 4 layers at
# d_model 512 (head_dim 128, which the flash kernel takes) in bf16: one of
# jamba's MoE layers alone is 19.3 GB of bf16 experts
SSM_ARCH, HYBRID_ARCH, HYBRID_LAYERS, HYBRID_D = ("mamba2-130m",
                                                  "jamba-1.5-large-398b", 4,
                                                  512)
# the vlm path: llama-3.2-vision-90b at full width, depth cut to one period
# (VLM_LAYERS = cross_attn_every: four self-attention layers, then the
# cross layer at index 4), its cross gates drawn from VLM_GATE_SEED (the
# reference initialises them to 0, which hides the cross branch), and
# 1024 patches of 1280 from the seed per request
VLM_ARCH, VLM_LAYERS, VLM_GATE_SEED = "llama-3.2-vision-90b", 5, 0
# its fp32 witness: a batch-1 prefill of VLM_WITNESS_S prompt tokens and
# all 1024 patches on the card against the same call on the CPU
VLM_WITNESS_S = 32
# the encoder-decoder path: whisper-base at full size, 8 requests of 1500
# frames and WHISPER_PROMPT prompt tokens; its fp32 batch-1 prefill on the
# card against the same call on the CPU
WHISPER_ARCH, WHISPER_PROMPT = "whisper-base", 64
# an fp32 result on the card against another fp32 computation of it (the
# CPU's, or the dense decode's for the paged one): the cpu phase's limit
FP32_TOL = (1e-4, 1e-3)  # rtol, atol
# the paged engine: SERVE_ARCH at full size, ENGINE_REQUESTS prompts of
# ENGINE_PROMPT tokens (uniform, numpy seed ENGINE_SEED), SERVE_NEW new
# tokens, pages of ENGINE_PAGE tokens, ENGINE_SLOTS slots, a pool of
# ENGINE_SLOTS x pages_per_slot pages (8 x 66)
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_SEED = 16, (512, 1024), 5
ENGINE_PAGE, ENGINE_SLOTS = 16, 8
# the training path: llama3.2-3b at full size, bf16 compute over fp32
# master weights and AdamW moments, remat "full", the port's synthetic data
# at TRAIN_B x TRAIN_S, TRAIN_STEPS steps (TRAIN_WARMUP of warmup), run a
# second time for its first TRAIN_REPEAT steps, which must give the same bits
TRAIN_ARCH, TRAIN_B, TRAIN_S = "llama3.2-3b", 4, 1024
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_REPEAT, TRAIN_LR = 8, 2, 3, 3e-4
# its witness: a reduced fp32 llama3.2-3b (2 layers, d_model 64) takes
# TRAIN_WITNESS_STEPS steps on the card and on the CPU from the same state;
# loss rtol, grad_norm rtol, weights atol, as tests/test_torch_train_step.py
# holds the CPU step against the reference
TRAIN_WITNESS_STEPS, TRAIN_WITNESS_TOL = 2, (1e-5, 3e-5, 1e-3)
# the explicit data-parallel step on DP_RANKS processes sharing the card:
# llama3.2-3b cut to DP_LAYERS layers at d_model DP_D and a vocab of
# DP_VOCAB (44.0e6 parameters, a 0.18 GB fp32 gradient), DP_STEPS steps of
# DP_B x DP_S tokens per schedule, the loss held at rtol DP_RTOL, the grad
# norm at rtol DP_GN_RTOL and the weights after DP_STEPS steps at atol
# DP_WEIGHT_ATOL against the one-rank step on the global batch (the last
# two as tests/test_torch_dp_step.py holds them)
DP_RANKS, DP_TIMEOUT = 4, 600.0
DP_LAYERS, DP_D, DP_VOCAB, DP_B, DP_S, DP_STEPS = 1, 1024, 32768, 8, 256, 2
DP_SCHEDULES = ("native", "chain", "rs_ag", "auto", "int8_ef")
DP_RTOL = 1e-5  # tests/dist/test_schedules.py:194-217
DP_GN_RTOL, DP_WEIGHT_ATOL = 3e-5, 1e-3
# int8_ef's first grad norm: its gradient is reduced through int8, whose
# rounding moved the norm by 4.5e-5 on the CPU at a small size; a reduction
# that is off by a constant factor moves it by far more
DP_INT8_GN_RTOL = 1e-3
# the schedules whose weights rank 0 hands back for that comparison
DP_WEIGHTS_OF = ("native", "rs_ag")
TRAIN_TIMEOUT = 600.0  # phase train's own process
# the explicit whole-model step on WHOLE_RANKS processes sharing the card:
# TRAIN_ARCH at full width cut to WHOLE_LAYERS layer, fp32 weights, moments
# and compute (495e6 parameters), remat "full", WHOLE_STEPS steps of
# WHOLE_B x WHOLE_S tokens per leg of WHOLE_LEGS (attention mode, engine
# schedule), each leg from the same state; against the one-rank step on
# the global batch: the loss at rtol WHOLE_TOL[0], the grad norm at rtol
# WHOLE_TOL[1] (tests/dist/test_transformer.py:92-100) and, for the legs of
# WHOLE_SAVED (their weights handed back through checkpoint.save), the
# weights at atol WHOLE_TOL[2] (phase dp's limit). Then the reference's
# reduction of qwen3-moe, tiny(4, layers=2), in fp32 for each mode x
# nchunks of WHOLE_MOE_CHUNKS on rs_ag, WHOLE_MOE_B x WHOLE_MOE_S tokens a
# step, to the same gates; then failover_bench's rank-loss section
WHOLE_RANKS, WHOLE_TIMEOUT = 4, 600.0
WHOLE_LAYERS, WHOLE_B, WHOLE_S, WHOLE_STEPS = 1, 8, 1024, 2
WHOLE_LEGS = (("tp", "native"), ("tp", "rs_ag"), ("sp", "rs_ag"))
WHOLE_SAVED = (("tp", "rs_ag"), ("sp", "rs_ag"))
WHOLE_MOE_CHUNKS = (1, "auto")
WHOLE_MOE_B, WHOLE_MOE_S = 4, 16
WHOLE_TOL = (1e-5, 1e-4, 1e-3)  # loss rtol, grad-norm rtol, weights atol
# the GSPMD placement on GSPMD_RANKS processes sharing the card, a 2x2
# ('data', 'model') mesh: phase whole's model at GSPMD_LAYERS layers, its
# batches and limits for the train legs of GSPMD_LEGS (name, fsdp; ZeRO-1
# on in both), an fp32 prefill of GSPMD_PREFILL_B x SERVE_S prompts, and a
# bf16 generate of SERVE_B x SERVE_S prompts plus SERVE_NEW tokens; then
# the ring legs. One layer (it was two): with phase gspmd_families the
# whole smoke took 1281 s of command time at two
GSPMD_RANKS, GSPMD_TIMEOUT = 4, 600.0
GSPMD_MESH = ((2, 2), ("data", "model"))
GSPMD_LEGS = (("zero1", False), ("fsdp", True))
GSPMD_LAYERS, GSPMD_PREFILL_B = 1, 4
# layers, d_model, vocab (None: full width), train rows, tokens, steps,
# prefill rows, serve rows, prompt tokens, new tokens
GSPMD_DIMS = (GSPMD_LAYERS, None, None, WHOLE_B, WHOLE_S, WHOLE_STEPS,
              GSPMD_PREFILL_B, SERVE_B, SERVE_S, SERVE_NEW)
# the explicit half of serving on SERVE_MESH_RANKS processes sharing the
# card (phase serve_mesh): SERVE_ARCH at full width cut to
# SERVE_MESH_LAYERS layers in fp32, SERVE_MESH_SLOTS slots of prompts of
# ENGINE_PROMPT tokens committed from the dense prefill into pages of
# ENGINE_PAGE, SERVE_MESH_STEPS decode steps of the explicit step per
# registered all_to_all_tiles schedule and auto against the one-rank paged
# step; MOE_ARCH at full width cut to SERVE_MESH_MOE_LAYERS layer the same
# way (each rank keeping its experts, the one-rank oracle run first in
# this process); the explicit ServeEngine and the GSPMD one on the 2x2
# mesh on phase engine's workload (ENGINE_REQUESTS x ENGINE_PROMPT,
# SERVE_NEW new tokens) against the one-rank engine; the explicit engine
# again in bf16, timed; then failover_bench's serve rank loss
SERVE_MESH_RANKS, SERVE_MESH_TIMEOUT = 4, 600.0
SERVE_MESH_LAYERS, SERVE_MESH_MOE_LAYERS = 2, 1
SERVE_MESH_SLOTS, SERVE_MESH_STEPS = 8, 8
# layers, d_model (None: full width), slots, prompt tokens (lo, hi),
# decode steps, requests, new tokens, moe layers
SERVE_MESH_DIMS = (SERVE_MESH_LAYERS, None, SERVE_MESH_SLOTS, ENGINE_PROMPT,
                   SERVE_MESH_STEPS, ENGINE_REQUESTS, SERVE_NEW,
                   SERVE_MESH_MOE_LAYERS)
# the explicit step against the one-rank paged step in fp32, logits and
# pages: the same operations on the same pages, the rows and heads cut
# differently; the reference holds its CPU test at tiny width to 2e-5, and
# at this width (logits sum 3072 fp32 products per layer) the engine's
# paged-vs-dense witness on the card reached 6.56e-5; a head or row on the
# wrong rank moves the logits by O(1)
SERVE_MESH_ATOL = 1e-4
# the other families on the GSPMD placement (phase gspmd_families):
# FAM_RANKS processes sharing the card, the 2x2 GSPMD_MESH; FAM_DIMS holds
# the widths (None: the catalog's; an int: reduce() to it, a CPU probe),
# MOE_ARCH's and VLM_ARCH's depths, the fp32 prefill's rows, the bf16
# generate's rows, the prompt tokens, the new tokens, the SSM's decode
# steps, the paged step's slots, mamba2's training rows (of ``seq``
# tokens), whisper's rows and tokens, and the train steps
FAM_RANKS, FAM_TIMEOUT = 4, 600.0
# the train legs' weights are held within WHOLE_TOL[2] everywhere, except
# in the legs of FAM_TINY_GRAD_LEGS: there only where the one-rank step's
# clipped gradient reached FAM_TINY_GRAD at every step (below it AdamW's
# lr g / (|g| + 1e-8) turns the ranks' reordered last bits into a share
# of lr: mamba2-130m's weights ended 1.46e-3 apart over all, 3.6e-4 where
# held, after 2 steps of lr 1e-3; the other legs' ended at most 2.7e-5
# apart over all), and their first moments everywhere within FAM_MU_ATOL
# (tests/test_torch_train_step.py's limit after two steps)
FAM_TINY_GRAD, FAM_MU_ATOL, FAM_TINY_GRAD_LEGS = 1e-6, 2e-5, ("mamba2",)
# the vlm's bf16 mesh prefill against the one-rank plain one: within
# FAM_VLM_BF16_SHARE times the bf16 flash limit, a fixed bound between the
# readings of a sound run (the mesh at 3.33-3.37 times the limit, the
# one-rank flash prefill itself at 3.08-3.14, at full width and 5 layers)
# and that of the mesh prefill with the cross gates closed, which must lie
# beyond it (PERF.md §6)
FAM_VLM_BF16_SHARE = 4.0
# qwen3-moe's bf16 mesh prefill against the one-rank plain one: at least
# FAM_MOE_BF16_WITHIN of its positions (rows x tokens) with every logit
# within the bf16 flash limit (bf16 router logits flip near-tied top-k
# choices, which moves those tokens' logits by O(1): 0.936-0.944 of the
# mesh's positions and 0.942-0.951 of the one-rank flash prefill's were
# within it at full width and 1 layer; a rank holding the wrong experts
# moves every token; PERF.md §6)
FAM_MOE_BF16_WITHIN = 0.9
FAM_FRAMES_SEED, FAM_PAGES_SEED = 3, 4
FAM_DIMS = {"width": None, "moe_layers": 1, "vlm_layers": VLM_LAYERS,
            "prefill_b": 4, "serve_b": SERVE_B, "seq": SERVE_S,
            "new": SERVE_NEW, "ssm_decode": 8, "paged_slots": 8,
            "train_b": 4, "whisper_b": 8, "whisper_s": WHISPER_PROMPT,
            "steps": WHOLE_STEPS}
# phase launch: the training launcher at phase train's full-size geometry,
# the examples, one dry-run cell; subprocesses of the repository's own
# entry points
LAUNCH_STEPS, LAUNCH_LR = 3, 1e-3     # --steps 3, the launcher's --lr default
LAUNCH_ARGS = ("--arch", TRAIN_ARCH, "--full", "--batch", str(TRAIN_B),
               "--seq", str(TRAIN_S), "--remat", "full", "--steps",
               str(LAUNCH_STEPS))
LAUNCH_PARAMS = 3_212_835_840          # llama3.2-3b's param_count()
# the launcher's losses against a direct train_loop on the flags' configs:
# the same program on the same card, so they agree to cuBLAS's run-to-run
# rounding; a run whose learning rate is the flags' doubled differs by
# far more at the last step, which the phase checks the limit rejects
LAUNCH_LOSS_RTOL = 1e-4
LAUNCH_TRAIN_LM_STEPS = 20
LAUNCH_DRYRUN = ("--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh",
                 "single")
LAUNCH_TIMEOUT = 600.0
# fp32 prefill, flash vs plain attention: both are fp32 throughout and
# differ only in the order of the attention's sums (a few ulps per layer),
# on logits of rms about 1; one bf16 rounding anywhere moves them by ~1e-2
FP32_PREFILL_ATOL = 1e-3
FLASH_ATOL = {"float32": 2e-4, "bfloat16": 8e-2}  # tests/test_kernels.py
FLASH_RTOL = 2e-2
# kernel and plain version sum the same fp32 terms in other orders (relative
# error ~1e-6) and round once to bf16; one rounding may land a whole ulp
# apart, at most 2^-7 |want|, and 1e-3 covers the fp32 slack
FLASH_TIGHT = {"atol": 1e-3, "rtol": 2.0 ** -7}
# H100 SXM data sheet (dense, no sparsity): HBM3 rate and peak rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12
# tolerances of tests/test_kernels.py
GEMM_ATOL = {"float32": 2e-4, "bfloat16": 8e-2}   # times sqrt(K); rtol 1e-2
LU_TOL = (1e-5, 1e-5)                             # rtol, atol
FP32_EPS = 2.0 ** -23
BF16_RTOL = 2.0 ** -7                             # one rounding to bf16
TRSM_TOL = (1e-4, 1e-4)
# sha256 (first 16 hex digits) of the outputs of ``lu_golden_calls``, as
# the first port's kernels (one-CTA LU, left-looking lower solve, the same
# upper solve) computed them on the card; every route keeps each element's
# operations, so the bits must not move
LU_BITS = {"lu64": "ec7b50fd4f142e9c", "lu48": "cec5aa2781f3ae5e",
           "lu128": "c8dffd4abe86797a", "trsm64": "7a82ad5a1edce600",
           "trsm48_1009": "2a91fd5c3d00b0a9", "trsm128": "029d3092a28149f0",
           "upper64": "9e1412487aaeaafa", "lu64_odd": "9006050a846e6526"}
# sha256 (first 16 hex digits) of the outputs of ``gemm_golden_calls``: the
# fp32 rows as the first port's gemm_update kernel computed them on the
# card, and every fp32 design keeps each output's sums (ascending k, one
# fused multiply-add per product from +0, then fmaf(alpha, sum, c)), so
# those bits must not move; ``bf16_16384`` as the bf16 tensor-core route
# (``wgmma_bf16``, whose sums run in the tensor core's order within each
# 16-deep step of K) first computed it
GEMM_BITS = {"hpl16384": "4baa42302537cd4f", "row_strip": "3a2fd3a9586b7761",
             "col_strip": "31b023ce8e054b65",
             "trailing8192": "ef17d0bba6e34e7a",
             "ragged37": "d4ef6ee3bdb9fd99", "bf16_16384": "ae2c94b1bbd8a905"}
# trailing updates timed in phase ``kernels``: views of HPL's C, row stride
# N_MAIN, as an update restricted to the trailing matrix would pass them
GEMM_TRAILING = (12288, 8192, 4096, 1024)
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"gemm_update": CSRC + "gemm_update.cu",
           "lu_factor_block": CSRC + "lu.cu",
           "trsm_lower_left": CSRC + "lu.cu",
           "trsm_upper_right": CSRC + "lu.cu",
           "transpose_add": CSRC + "transpose_add.cu",
           "stream_copy": CSRC + "stream.cu",
           "stream_scale": CSRC + "stream.cu",
           "stream_add": CSRC + "stream.cu",
           "stream_triad": CSRC + "stream.cu",
           "matmul": CSRC + "matmul.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "ring_add_step": CSRC + "ring_add.cu"}
REPLACES = {"gemm_update": "src/repro/kernels/gemm.py:82",
            "lu_factor_block": "src/repro/kernels/lu.py:49",
            "trsm_lower_left": "src/repro/kernels/lu.py:86",
            "trsm_upper_right": "src/repro/kernels/lu.py:125",
            "transpose_add": "src/repro/kernels/transpose.py:25",
            "stream_copy": "src/repro/kernels/stream.py:43",
            "stream_scale": "src/repro/kernels/stream.py:43",
            "stream_add": "src/repro/kernels/stream.py:43",
            "stream_triad": "src/repro/kernels/stream.py:43",
            "matmul": "src/repro/kernels/gemm.py:45",
            "flash_attention": "src/repro/kernels/attention.py:69",
            "ring_add_step": "src/repro/kernels/ring.py:27"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def alternated_ms(torch, fns, rounds: int, iters: int, timer=None) -> dict:
    """Median time of each of ``fns`` (``cuda_ms`` with one warm-up call,
    or ``timer``) over ``rounds`` rounds, the order rotated and reversed
    from round to round, so that clock and thermal drift fall on every
    function alike."""
    names, times = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order[::-1] if r % 2 else order):
            times[k].append(timer(torch, fns[k], iters) if timer else
                            cuda_ms(torch, fns[k], iters, warmup=1))
    return {k: statistics.median(v) for k, v in times.items()}


def queued_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn`` run back to back, the host's excluded:
    the calls are queued behind a sleep kernel that outlasts their enqueue
    four times over, then run between two CUDA events. For calls of a few
    microseconds, where back-to-back events (``cuda_ms``) time the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * host_s * 2e9))  # cycles, at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS):
    """Least time the card could take: bytes at the HBM rate against
    operations at the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def allclose(torch, got, want, rtol, atol):
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rms(x) -> float:
    return float(x.float().square().mean().sqrt())


def sum_atol(k: int, rms_a: float, rms_b: float) -> float:
    """Limit for two fp32 sums of the same K products that differ only in
    rounding (fused multiply-add or not): 16 eps sqrt(K) times the output's
    scale sqrt(K) rms(a) rms(b)."""
    return 16 * FP32_EPS * k * rms_a * rms_b


def cuda_once(torch, fn):
    """``fn()`` once: its result and its device time in ms."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bitwise(torch, got, want) -> bool:
    """Same shape, dtype and bits (integer views compared)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32,
            8: torch.int64}[got.element_size()]
    return bool(torch.equal(got.contiguous().view(view),
                            want.contiguous().view(view)))


def phase_build(card: str):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = []
    for stem in libs:
        log = _build.build_dir() / f"{stem}.log"
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "card": card, "seconds": seconds,
          "libs": sorted(libs),
          "dir": str(_build.build_dir().relative_to(ROOT)), "ptxas": ptxas})


def phase_kernels(torch):
    """Each kernel against its plain version at HPL's shapes; times."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import lu as klu
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def dominant(n):
        return randn(n, n) + n * torch.eye(n, device=dev)

    m, b = N_MAIN, B_MAIN
    rows = {}

    checked_gemm = kernels_gemm(torch, randn, rows)
    checked_lu = kernels_lu(torch, randn, dominant, rows)

    # ragged and strided shapes: edges of tiles, slabs that are not 256
    # wide, a block of 48, views with row strides wider than their rows
    big = randn(300, 512)
    c_view, a_view, b_small = big[:, 64:397], randn(300, 80)[:, 3:40], \
        randn(37, 333)
    want = ref.gemm_update(c_view, a_view, b_small, alpha=0.5)
    got = kgemm.gemm_update(c_view.clone(), a_view, b_small, alpha=0.5)
    ragged = {"gemm_update": allclose(torch, got, want, 1e-2,
                                      GEMM_ATOL["float32"] * math.sqrt(37))}
    kgemm.gemm_update(c_view, a_view, b_small, alpha=0.5)  # into ``big``
    check(torch.equal(big[:, 64:397], got),
          "gemm_update on a strided view differs from the same update "
          "on a contiguous copy")
    blk48 = dominant(96)[:48, :48]
    lu48 = ref.lu_factor_block(blk48)
    ragged["lu_factor_block"] = allclose(
        torch, klu.lu_factor_block(blk48), lu48, *LU_TOL)
    p = randn(48, 1200)[:, :1000]
    ragged["trsm_lower_left"] = allclose(
        torch, klu.trsm_lower_left(lu48, p), ref.trsm_lower_left(lu48, p),
        *TRSM_TOL)
    p = randn(1000, 64)[:, 5:53]
    ragged["trsm_upper_right"] = allclose(
        torch, klu.trsm_upper_right(lu48, p), ref.trsm_upper_right(lu48, p),
        *TRSM_TOL)
    for name, (ok, err) in ragged.items():
        check(ok, f"{name} disagrees with its plain version on a ragged "
                  f"shape: {err}")
    del big, c_view, a_view, b_small, want, got, p
    torch.cuda.empty_cache()
    checked = checked_gemm + checked_lu
    checked += kernels_transpose_add(torch, randn, rows)
    checked += kernels_stream(torch, randn, rows)
    checked += kernels_matmul(torch, randn, rows)
    checked += kernels_flash(torch, randn, rows)
    checked += kernels_ring(torch, randn, rows)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "main_path_shapes": rows,
          "ragged_max_abs_err": {k: v[1] for k, v in ragged.items()},
          "also_checked": checked})
    return rows


def kernels_gemm(torch, randn, rows):
    """gemm_update at HPL's update, C (m, m) -= L (m, b) @ U (b, m), fp32,
    against its plain version, timed against ``torch.addmm`` (TF32 off) in
    STREAM_ROUNDS alternated rounds; the shape table: trailing views of
    that C (GEMM_TRAILING, row stride m) and the lookahead's two strips,
    each against its plain version and timed with ``torch.addmm``
    (``queued_ms``, alternated); the same update in bf16 on its
    tensor-core route, within the plain version's limit, two runs
    bit-identical, HPL's row and column strips (B a strided view) each
    bit-identical to the full update's rows and columns, timed against
    ``torch.addmm`` in bf16; and the output bits of ``gemm_golden_calls``
    against :data:`GEMM_BITS`."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import ref

    m, b = N_MAIN, B_MAIN
    c0, a, bb = randn(m, m), randn(m, b), randn(b, m)
    want = ref.gemm_update(c0, a, bb, alpha=-1.0)
    got = on_route(kgemm.gemm_update, "simt_f32",
                   lambda: kgemm.gemm_update(c0.clone(), a, bb, alpha=-1.0))
    atol = GEMM_ATOL["float32"] * math.sqrt(b)
    ok, err = allclose(torch, got, want, 1e-2, atol)
    check(ok, f"gemm_update fp32 disagrees with its plain version: {err}")
    del want, got
    c_run = c0.clone()
    med = alternated_ms(torch, {
        "kernel": lambda: kgemm.gemm_update(c_run, a, bb),
        "library": lambda: torch.addmm(c0, a, bb, alpha=-1.0)},
        STREAM_ROUNDS, iters=10)
    plain_ms = cuda_ms(torch, lambda: ref.gemm_update(c0, a, bb), iters=2,
                       warmup=1)
    del c_run

    def update_bound(M, N, esize=4, peak=FP32_FLOPS):
        return bound(esize * (M * b + b * N + 2 * M * N), 2 * M * N * b,
                     peak)

    # the shape table: trailing views of C (row stride m) and the strips
    # HPL's lookahead updates, 64 x m and m x 64 (core/hpl.py)
    s, work = slice(b, 2 * b), c0.clone()
    shapes = {f"trailing {t}^2, row stride {m}": (
        c0[m - t:, m - t:], a[m - t:], bb[:, m - t:], work[m - t:, m - t:])
        for t in GEMM_TRAILING}
    shapes[f"row strip ({b},{m})"] = (c0[s, :].clone(), a[s, :], bb,
                                      c0[s, :].clone())
    shapes[f"column strip ({m},{b})"] = (c0[:, s].clone(), a, bb[:, s],
                                         c0[:, s].clone())
    table = {}
    for label, (c, x, y, c_run) in shapes.items():
        want = ref.gemm_update(c, x, y, alpha=-1.0)
        c_run.copy_(c)  # a larger view's runs updated it
        ok, err_s = allclose(torch, kgemm.gemm_update(c_run, x, y), want,
                             1e-2, atol)
        check(ok, f"gemm_update disagrees with its plain version: {label}: "
                  f"{err_s}")
        del want
        times = alternated_ms(torch, {
            "kernel": lambda: kgemm.gemm_update(c_run, x, y),
            "library": lambda: torch.addmm(c, x, y, alpha=-1.0)},
            3, iters=20, timer=queued_ms)
        bms_s, by_s = update_bound(*c.shape)
        table[label] = dict(ms=times["kernel"], bound_ms=bms_s, bound_by=by_s,
                            library_ms=times["library"], max_abs_err=err_s)
    del shapes, work
    bms, by = update_bound(m, m)
    rows["gemm_update"] = dict(
        shape=f"C({m},{m}) A({m},{b}) B({b},{m}) fp32", max_abs_err=err,
        tol={"atol": atol, "rtol": 1e-2}, ms=med["kernel"], plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=med["library"],
        library="torch.addmm(c, a, b, alpha=-1), allow_tf32=False",
        ms_over_library=med["kernel"] / med["library"],
        bound_share=bms / med["kernel"], kernel_route="simt_f32",
        timing=f"ms, library_ms: medians of {STREAM_ROUNDS} alternated "
               "rounds of cuda_ms over 10 calls; shapes: 3 alternated "
               "rounds of queued_ms over 20 calls",
        shapes=table)

    # the same update in bf16 on its tensor-core route (fp32 sums of exact
    # products, rounded once): within the plain version's limit, two runs
    # bit-identical, and HPL's row and column strips, each updated alone,
    # bit-identical to the same rows and columns of the full update
    c16, a16, b16 = c0.bfloat16(), a.bfloat16(), bb.bfloat16()
    del c0
    want = ref.gemm_update(c16, a16, b16, alpha=-1.0)
    got = on_route(kgemm.gemm_update, "wgmma_bf16",
                   lambda: kgemm.gemm_update(c16.clone(), a16, b16,
                                             alpha=-1.0))
    atol16 = GEMM_ATOL["bfloat16"] * math.sqrt(b)
    ok, err16 = allclose(torch, got, want, 1e-2, atol16)
    check(ok, f"gemm_update bf16 disagrees with its plain version: {err16}")
    del want
    check(bitwise(torch, kgemm.gemm_update(c16.clone(), a16, b16), got),
          "gemm_update bf16: two runs of one update differ")
    strips = {f"row strip ({b},{m})": (
        lambda: kgemm.gemm_update(c16[s, :].clone(), a16[s, :], b16),
        got[s, :]),
        f"column strip ({m},{b}), B a view with row stride {m}": (
        lambda: kgemm.gemm_update(c16[:, s].clone(), a16, b16[:, s]),
        got[:, s])}
    for label, (fn, full) in strips.items():
        check(bitwise(torch, fn(), full), f"gemm_update bf16: the {label} "
                                          "differs from the full update's")
    del got, strips
    c_run = c16.clone()
    med16 = alternated_ms(torch, {
        "kernel": lambda: kgemm.gemm_update(c_run, a16, b16),
        "library": lambda: torch.addmm(c16, a16, b16, alpha=-1.0)},
        STREAM_ROUNDS, iters=10)
    plain16 = cuda_ms(torch, lambda: ref.gemm_update(c16, a16, b16), iters=2,
                      warmup=1)
    del c_run
    bms16, by16 = update_bound(m, m, 2, BF16_TENSOR_FLOPS)
    bf16_row = dict(
        shape=f"C({m},{m}) A({m},{b}) B({b},{m}) bf16",
        kernel_route="wgmma_bf16", max_abs_err=err16,
        tol={"atol": atol16, "rtol": 1e-2}, bitwise_repeat=True,
        strips_bitwise_full=True, ms=med16["kernel"], plain_ms=plain16,
        bound_ms=bms16, bound_by=by16, bound_share=bms16 / med16["kernel"],
        library_ms=med16["library"],
        library="torch.addmm(c, a, b, alpha=-1), bf16",
        ms_over_library=med16["kernel"] / med16["library"],
        timing=f"ms, library_ms: medians of {STREAM_ROUNDS} alternated "
               "rounds of cuda_ms over 10 calls")
    rows["gemm_update"]["wgmma_bf16"] = bf16_row
    emit({"phase": "kernels.bf16", "kernel": "gemm_update", **bf16_row,
          "launches_by_route": dict(kgemm.gemm_update.launches_by_route)})
    del c16, a16, b16, a, bb
    torch.cuda.empty_cache()

    # every output bit as the first port's kernel gave it
    checked = []
    for label, fn in gemm_golden_calls(torch, kgemm).items():
        got = bits_sha(fn())
        check(got == GEMM_BITS[label], f"gemm_update {label}: output bits "
                                       f"{got}, not {GEMM_BITS[label]}")
        checked.append(f"gemm_update {label}: bits {got}, as recorded")
    torch.cuda.empty_cache()
    return checked


def lu_golden_calls(torch, klu):
    """The HPL kernels' calls whose output bits :data:`LU_BITS` records:
    inputs from numpy's generator (seed 16), the same on every machine, at
    HPL's shapes, a strided 48 x 48 block, a strided prime-width panel, the
    second routes' 128 and a 64 x 64 view off 16-byte alignment."""
    import numpy as np

    rng = np.random.default_rng(16)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

    def dominant(n):
        a = rng.standard_normal((n, n)).astype(np.float32)
        a[np.arange(n), np.arange(n)] += n
        return a

    blk64, blk48 = cuda(dominant(64)), cuda(dominant(96))[:48, :48]
    blk128 = cuda(dominant(128))
    pk64, pk48 = cuda(dominant(64) / 64), cuda(dominant(48) / 48)
    pk128 = cuda(dominant(128) / 128)  # packed L\U-like: unit-ish diagonal
    top = cuda(rng.standard_normal((64, N_MAIN)))
    top48 = cuda(rng.standard_normal((48, 1200)))[:, 100:1109]  # N = 1009
    top128 = cuda(rng.standard_normal((128, 1000)))
    left = cuda(rng.standard_normal((N_MAIN, 64)))
    odd = cuda(dominant(70))[3:67, 3:67]  # unaligned: the general load
    return {"lu64": lambda: klu.lu_factor_block(blk64),
            "lu64_odd": lambda: klu.lu_factor_block(odd),
            "lu48": lambda: klu.lu_factor_block(blk48),
            "lu128": lambda: klu.lu_factor_block(blk128),
            "trsm64": lambda: klu.trsm_lower_left(pk64, top),
            "trsm48_1009": lambda: klu.trsm_lower_left(pk48, top48),
            "trsm128": lambda: klu.trsm_lower_left(pk128, top128),
            "upper64": lambda: klu.trsm_upper_right(pk64, left)}


def gemm_golden_calls(torch, kgemm):
    """``gemm_update``'s calls whose output bits :data:`GEMM_BITS` records:
    inputs from numpy's generator (seed 19), the same on every machine.
    HPL's update (C 16384^2, K 64), the lookahead's row strip (64 x 16384)
    and column strip (16384 x 64, B a 64 x 64 view with row stride 16384),
    a trailing 8192^2 view with row stride 16384, the ragged strided view
    of ``phase_kernels`` with K = 37, and HPL's update in bf16. Each call
    updates a fresh copy of C and returns the updated view."""
    import numpy as np

    rng = np.random.default_rng(19)

    def cuda(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()

    m, b = N_MAIN, B_MAIN
    c, l, u = cuda(m, m), cuda(m, b), cuda(b, m)
    big, a_view, b_small = cuda(300, 512), cuda(300, 80)[:, 3:40], \
        cuda(37, 333)
    c16, l16, u16 = c.bfloat16(), l.bfloat16(), u.bfloat16()
    s, h = slice(b, 2 * b), m // 2
    return {
        "hpl16384": lambda: kgemm.gemm_update(c.clone(), l, u),
        "row_strip": lambda: kgemm.gemm_update(c[s, :].clone(), l[s, :], u),
        "col_strip": lambda: kgemm.gemm_update(c[:, s].clone(), l, u[:, s]),
        "trailing8192": lambda: kgemm.gemm_update(c.clone()[h:, h:], l[h:],
                                                  u[:, h:]),
        "ragged37": lambda: kgemm.gemm_update(big.clone()[:, 64:397], a_view,
                                              b_small, alpha=0.5),
        "bf16_16384": lambda: kgemm.gemm_update(c16.clone(), l16, u16)}


def bits_sha(t) -> str:
    import torch

    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:  # no numpy type: hash its bits
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def kernels_lu(torch, randn, dominant, rows):
    """HPL's three panel kernels at HPL's shapes (b = 64, m = 16384; the
    Left panel a column strip of an m x m matrix, as HPL passes it): each
    on the route the shape must take, against its plain version, timed with
    the nearest library call; also at the ragged 48, at 128 (their second
    routes), on strided panels of prime width or height and on an
    unaligned 64 x 64 view; and all three kernels' output bits against
    :data:`LU_BITS`. Times: ``queued_ms``, since back-to-back launches of a
    kernel of a few microseconds time the host's wrapper (``cuda_ms``,
    reported beside)."""
    from repro_torch.kernels import lu as klu
    from repro_torch.kernels import ref

    m, b = N_MAIN, B_MAIN
    checked = []
    lu_w, lo_w = klu.lu_factor_block, klu.trsm_lower_left
    up_w = klu.trsm_upper_right

    def timed(fn, lib):
        return dict(ms=queued_ms(torch, fn, 200),
                    ms_events=cuda_ms(torch, fn, iters=200),
                    library_ms=queued_ms(torch, lib, 200),
                    library_ms_events=cuda_ms(torch, lib, iters=200),
                    timing="ms, library_ms: queued_ms (device, back to "
                           "back); *_events: cuda_ms (host-bound here)")

    # lu_factor_block: HPL's (b, b) diagonal block
    blk = dominant(b)
    want = ref.lu_factor_block(blk)
    got = on_route(lu_w, "warp_regs", lambda: klu.lu_factor_block(blk))
    ok, err = allclose(torch, got, want, *LU_TOL)
    check(ok, f"lu_factor_block disagrees with its plain version: {err}")
    flops = sum((b - k - 1) + 2 * (b - k - 1) ** 2 for k in range(b))
    bms, by = bound(4 * 2 * b * b, flops)
    rows["lu_factor_block"] = dict(
        shape=f"({b},{b}) fp32", kernel_route="warp_regs", max_abs_err=err,
        tol={"rtol": LU_TOL[0], "atol": LU_TOL[1]},
        plain_ms=cuda_ms(torch, lambda: ref.lu_factor_block(blk), iters=5),
        bound_ms=bms, bound_by=by,
        **timed(lambda: klu.lu_factor_block(blk),
                lambda: torch.linalg.lu_factor_ex(blk, pivot=False)),
        library="torch.linalg.lu_factor_ex(a, pivot=False)")

    # trsm_lower_left: the Top panel, X (b, m) = L^{-1} A_kj
    lu_blk = want
    panel = randn(b, m)
    want = ref.trsm_lower_left(lu_blk, panel)
    got = on_route(lo_w, "regs64", lambda: klu.trsm_lower_left(lu_blk, panel))
    ok, err = allclose(torch, got, want, *TRSM_TOL)
    check(ok, f"trsm_lower_left disagrees with its plain version: {err}")
    bms, by = bound(4 * (b * b + 2 * b * m), m * b * (b - 1))
    rows["trsm_lower_left"] = dict(
        shape=f"lu({b},{b}) B({b},{m}) fp32", kernel_route="regs64",
        max_abs_err=err, tol={"rtol": TRSM_TOL[0], "atol": TRSM_TOL[1]},
        plain_ms=cuda_ms(torch, lambda: ref.trsm_lower_left(lu_blk, panel),
                         iters=5),
        bound_ms=bms, bound_by=by,
        **timed(lambda: klu.trsm_lower_left(lu_blk, panel),
                lambda: torch.linalg.solve_triangular(
                    lu_blk, panel, upper=False, unitriangular=True)),
        library="torch.linalg.solve_triangular(lu, b, upper=False, "
                "unitriangular=True)")

    # trsm_upper_right: the Left panel, X (m, b) = A_ik U^{-1}, on HPL's
    # layout: a column strip of an (m, m) matrix, row stride m
    matrix = randn(m, m)
    left = matrix[:, b:2 * b]
    want = ref.trsm_upper_right(lu_blk, left)
    got = on_route(up_w, "regs64", lambda: klu.trsm_upper_right(lu_blk, left))
    ok, err = allclose(torch, got, want, *TRSM_TOL)
    check(ok, f"trsm_upper_right disagrees with its plain version: {err}")
    bms, by = bound(4 * (b * b + 2 * b * m), m * b * b)
    rows["trsm_upper_right"] = dict(
        shape=f"lu({b},{b}) B({m},{b}) row stride {m} fp32",
        kernel_route="regs64", max_abs_err=err,
        tol={"rtol": TRSM_TOL[0], "atol": TRSM_TOL[1]},
        plain_ms=cuda_ms(torch, lambda: ref.trsm_upper_right(lu_blk, left),
                         iters=5),
        bound_ms=bms, bound_by=by,
        **timed(lambda: klu.trsm_upper_right(lu_blk, left),
                lambda: torch.linalg.solve_triangular(
                    lu_blk, left, upper=True, left=False)),
        library="torch.linalg.solve_triangular(lu, b, upper=True, "
                "left=False)")
    del want, got, left, matrix

    # the ragged 48 (a strided view), the largest block 128, strided panels
    # of prime width (height): each on its route, against the plain version
    blk48, blk128 = dominant(96)[:48, :48], dominant(128)
    lu48, lu128 = ref.lu_factor_block(blk48), ref.lu_factor_block(blk128)
    cases = {
        "lu_factor_block n=48 (strided)": (
            lu_w, "warp_regs", lambda: klu.lu_factor_block(blk48), lu48,
            LU_TOL),
        "lu_factor_block n=128": (
            lu_w, "cta_smem", lambda: klu.lu_factor_block(blk128), lu128,
            LU_TOL)}
    for n, N, lu_n in ((48, 1000, lu48), (128, 1000, lu128),
                       (b, 1009, lu_blk), (48, 1009, lu48)):
        p = randn(n, N + 91)[:, 45:45 + N]
        route = klu.trsm_lower_route(n)
        cases[f"trsm_lower_left n={n} N={N} (strided)"] = (
            lo_w, route,
            lambda lu_n=lu_n, p=p: klu.trsm_lower_left(lu_n, p),
            ref.trsm_lower_left(lu_n, p), TRSM_TOL)
    for n, M, lu_n in ((48, 1009, lu48), (128, 1000, lu128),
                       (b, m, lu_blk)):
        p = randn(M, n + 91)[:, 45:45 + n]
        route = klu.trsm_upper_route(n)
        cases[f"trsm_upper_right n={n} M={M} (strided)"] = (
            up_w, route,
            lambda lu_n=lu_n, p=p: klu.trsm_upper_right(lu_n, p),
            ref.trsm_upper_right(lu_n, p), TRSM_TOL)
    for label, (wrapper, route, fn, want, tol) in cases.items():
        ok, err = allclose(torch, on_route(wrapper, route, fn), want, *tol)
        check(ok, f"{label} on {route} disagrees with its plain version: "
                  f"{err}")
        checked.append(f"{label}: {route}, max_abs_err {err:.3g}")

    # a 64 x 64 view off 16-byte alignment (row stride 70, offset 213
    # floats), diagonally dominant as HPL's blocks are: the warp route's
    # general load, not the float4 one
    blk_odd = dominant(70)[3:67, 3:67]
    ok, err = allclose(torch, klu.lu_factor_block(blk_odd),
                       ref.lu_factor_block(blk_odd), *LU_TOL)
    check(ok, f"lu_factor_block on an unaligned 64 x 64 view disagrees with "
              f"its plain version: {err}")
    del panel, blk_odd

    # every output bit as the first port's kernels gave it
    for label, fn in lu_golden_calls(torch, klu).items():
        got = bits_sha(fn())
        check(got == LU_BITS[label], f"{label}: output bits {got}, not "
                                     f"{LU_BITS[label]}")
        checked.append(f"{label}: bits {got}, as recorded")
    torch.cuda.empty_cache()
    return checked


def kernels_transpose_add(torch, randn, rows):
    """transpose_add at PTRANS's 16384^2 fp32, bit for bit; then ragged,
    strided and bf16 shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import transpose as ktr

    n = N_PTRANS
    a, b = randn(n, n), randn(n, n)
    got, want = ktr.transpose_add(a, b), ref.transpose_add(a, b)
    check(bitwise(torch, got, want),
          "transpose_add differs from its plain version at 16384^2 fp32")
    err = max_abs(got, want)
    del got, want
    bms, by = bound(3 * 4 * n * n, n * n)
    rows["transpose_add"] = dict(
        shape=f"A({n},{n}) B({n},{n}) fp32", max_abs_err=err,
        tol="bitwise", ms=cuda_ms(torch, lambda: ktr.transpose_add(a, b),
                                  iters=20),
        plain_ms=cuda_ms(torch, lambda: ref.transpose_add(a, b), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.add(b, a.t()), iters=20),
        library="torch.add(b, a.t())")
    del a, b
    torch.cuda.empty_cache()
    checked = []
    # ragged (edge tiles both ways), strided (column strip of B, row view of
    # A), bf16 at a main-path-like and a ragged shape
    cases = {"ragged 1000x333": (randn(1000, 333), randn(333, 1000)),
             "strided": (randn(300, 700)[:, 50:650], randn(600, 900)[:, 7:307]),
             "bf16 4096^2": (randn(4096, 4096, dtype=torch.bfloat16),
                             randn(4096, 4096, dtype=torch.bfloat16)),
             "bf16 ragged 77x1030": (randn(77, 1030, dtype=torch.bfloat16),
                                     randn(1030, 77, dtype=torch.bfloat16))}
    for label, (x, y) in cases.items():
        check(bitwise(torch, ktr.transpose_add(x, y),
                      ref.transpose_add(x, y)),
              f"transpose_add differs from its plain version: {label}")
        checked.append(f"transpose_add {label}: bitwise")
    return checked


def kernels_stream(torch, randn, rows):
    """The four STREAM ops at 2^28 fp32 elements, bit for bit, each timed
    against its library call in STREAM_ROUNDS alternated rounds; then a
    size of 128 x odd on misaligned views (the scalar path) and aligned
    (the vector path's partial last tile), and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream as kst

    n, alpha = STREAM_ELEMS, 3.0
    a, b = randn(n), randn(n)
    calls = {  # kernel, plain version, library call, bytes, operations
        "stream_copy": (lambda: kst.stream_copy(a), lambda: ref.stream_copy(a),
                        lambda: a.clone(), 2, 0, "a.clone()"),
        "stream_scale": (lambda: kst.stream_scale(a, alpha),
                         lambda: ref.stream_scale(a, alpha),
                         lambda: torch.mul(a, alpha), 2, 1,
                         "torch.mul(a, alpha)"),
        "stream_add": (lambda: kst.stream_add(a, b),
                       lambda: ref.stream_add(a, b),
                       lambda: torch.add(a, b), 3, 1, "torch.add(a, b)"),
        "stream_triad": (lambda: kst.stream_triad(a, b, alpha),
                         lambda: ref.stream_triad(a, b, alpha),
                         lambda: torch.add(a, b, alpha=alpha), 3, 2,
                         "torch.add(b, c, alpha=alpha)")}
    for name, (kern, plain, lib, nbytes, nops, libname) in calls.items():
        got, want = kern(), plain()
        check(bitwise(torch, got, want),
              f"{name} differs from its plain version at 2^28 fp32")
        err = max_abs(got, want)
        del got, want
        bms, by = bound(nbytes * 4 * n, nops * n)
        med = alternated_ms(torch, {"kernel": kern, "library": lib},
                            STREAM_ROUNDS, iters=10)
        rows[name] = dict(
            shape=f"{n} fp32", max_abs_err=err, tol="bitwise",
            ms=med["kernel"], plain_ms=cuda_ms(torch, plain, iters=5),
            bound_ms=bms, bound_by=by, library_ms=med["library"],
            library=libname, ms_over_library=med["kernel"] / med["library"],
            hbm_share=bms / med["kernel"],
            library_hbm_share=bms / med["library"],
            timing=f"ms, library_ms: medians of {STREAM_ROUNDS} alternated "
                   "rounds of cuda_ms over 10 calls")
        torch.cuda.empty_cache()
    del a, b
    torch.cuda.empty_cache()
    checked = []
    m = 128 * 4099
    big = randn(2 * m + 3)
    x, y = big[1:1 + m], big[m + 2:2 + 2 * m]  # not 16-byte aligned
    x16, y16 = randn(1 << 20, dtype=torch.bfloat16), \
        randn(1 << 20, dtype=torch.bfloat16)
    # 128 x 4099 aligned: the vector path's last tile, partial and masked
    for label, (u, v) in {"misaligned 128x4099": (x, y),
                          "aligned 128x4099": (randn(m), randn(m)),
                          "bf16 2^20": (x16, y16)}.items():
        for name, kern, plain in (
                ("stream_copy", lambda: kst.stream_copy(u),
                 lambda: ref.stream_copy(u)),
                ("stream_scale", lambda: kst.stream_scale(u, alpha),
                 lambda: ref.stream_scale(u, alpha)),
                ("stream_add", lambda: kst.stream_add(u, v),
                 lambda: ref.stream_add(u, v)),
                ("stream_triad", lambda: kst.stream_triad(u, v, alpha),
                 lambda: ref.stream_triad(u, v, alpha))):
            check(bitwise(torch, kern(), plain()),
                  f"{name} differs from its plain version: {label}")
        checked.append(f"stream ops {label}: bitwise")
    return checked


def kernels_matmul(torch, randn, rows):
    """matmul at the GEMM phase's 8192^3 fp32 against its plain loop (one
    call, about 3 s) and torch.matmul (TF32 off), within fp32 rounding;
    the limit must reject a TF32 product and a product that drops one K
    step. Then ragged, strided and bf16 shapes against the plain loop."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import ref

    m = M_GEMM
    a, b = randn(m, m) / math.sqrt(m), randn(m, m) / math.sqrt(m)
    atol = sum_atol(m, rms(a), rms(b))
    got = kgemm.matmul(a, b)
    want, plain_ms = cuda_once(torch, lambda: ref.matmul(a, b))
    ok, err = allclose(torch, got, want, 0.0, atol)
    check(ok, f"matmul disagrees with its plain version at {m}^3: "
              f"{err} > {atol}")
    ok, err_lib = allclose(torch, got, torch.matmul(a, b), 0.0, atol)
    check(ok, f"matmul disagrees with torch.matmul at {m}^3: "
              f"{err_lib} > {atol}")
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok_tf32, err_tf32 = allclose(torch, tf32, want, 0.0, atol)
    k = m // 2
    ok_drop, err_drop = allclose(torch, got - torch.outer(a[:, k], b[k]),
                                 want, 0.0, atol)
    check(not ok_tf32 and not ok_drop,
          f"matmul's limit {atol} passes a TF32 product ({err_tf32}) or a "
          f"dropped K step ({err_drop})")
    # the order of sums is gemm_update's (ascending k, one FMA each from 0):
    # C = 0 + 1 * sum equals the sum, up to the sign of a zero
    order = kgemm.gemm_update(torch.zeros_like(got), a, b, alpha=1.0)
    check(torch.equal(got, order), "matmul's sums differ from gemm_update's "
                                   f"order: {max_abs(got, order)}")
    del got, want, tf32, order
    torch.cuda.empty_cache()
    bms, by = bound(3 * 4 * m * m, 2 * m ** 3)
    rows["matmul"] = dict(
        shape=f"A({m},{m}) B({m},{m}) fp32", max_abs_err=err,
        max_abs_err_vs_library=err_lib,
        tol={"atol": atol, "rtol": 0.0, "rule": "16 eps K rms(a) rms(b)"},
        equals_gemm_update_order=True,
        limit_rejects={"tf32_max_abs_err": err_tf32,
                       "dropped_k_step_max_abs_err": err_drop},
        ms=cuda_ms(torch, lambda: kgemm.matmul(a, b), iters=5, warmup=1),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), iters=5,
                           warmup=1),
        library="torch.matmul(a, b), allow_tf32=False")
    del a, b
    torch.cuda.empty_cache()
    checked = []
    cases = {"ragged 1000x777x555": (randn(1000, 777), randn(777, 555), None),
             "strided": (randn(300, 600)[:, 11:300], randn(400, 700)[:289, 5:600],
                         None),
             "bf16 1024^3": (randn(1024, 1024, dtype=torch.bfloat16),
                             randn(1024, 1024, dtype=torch.bfloat16), None),
             "bf16 in, fp32 out, ragged": (
                 randn(130, 257, dtype=torch.bfloat16),
                 randn(257, 99, dtype=torch.bfloat16), torch.float32),
             "fp32 in, bf16 out": (randn(200, 64), randn(64, 300),
                                   torch.bfloat16)}
    for label, (x, y, out_dtype) in cases.items():
        dt = out_dtype or x.dtype
        tol = sum_atol(x.shape[1], rms(x), rms(y))
        rtol = BF16_RTOL if dt == torch.bfloat16 else 0.0
        got = kgemm.matmul(x, y, out_dtype=out_dtype)
        check(got.dtype == dt, f"matmul {label}: dtype {got.dtype}")
        ok, err = allclose(torch, got, ref.matmul(x, y, out_dtype), rtol,
                           tol)
        check(ok, f"matmul disagrees with its plain version: {label}: {err}")
        checked.append(f"matmul {label}: max_abs_err {err:.3g} <= {tol:.3g}"
                       f" + {rtol:.3g}|want|")
    return checked


def flash_flops(B, H, Sq, Skv, hd, causal, q_offset=0):
    """2 * hd multiply-adds for QK^T and as many for PV, per (query, key)
    pair the mask keeps: 4 * B * H * hd * pairs."""
    if causal:
        pairs = sum(min(Skv, q_offset + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    return 4 * B * H * hd * pairs


def flash_faults(kfa, got, q, k, v):
    """Outputs of the kernel under three faults that move only late rows,
    made by launching it on slices of the inputs: the last q tile (64 rows)
    without its diagonal kv tile, as a kv loop that stops one tile short
    there would give; the same tile's kv loop one key short, so that only
    the last query loses a key, its own; and rows from S/2 on seeing one
    key past the diagonal, as a mask off by one there would give."""
    S = q.shape[1]
    tail = S - 64
    dropped = got.clone()
    dropped[:, tail:] = kfa.flash_attention(q[:, tail:], k[:, :tail],
                                            v[:, :tail], causal=True,
                                            q_offset=tail)
    short = got.clone()
    short[:, tail:] = kfa.flash_attention(q[:, tail:], k[:, :S - 1],
                                          v[:, :S - 1], causal=True,
                                          q_offset=tail)
    shifted = got.clone()
    shifted[:, S // 2:] = kfa.flash_attention(q[:, S // 2:], k, v,
                                              causal=True,
                                              q_offset=S // 2 + 1)
    return {"last_diagonal_tile_dropped": dropped,
            "last_key_dropped": short,
            "mask_off_by_one_late_rows": shifted}


def on_route(wrapper, route, fn):
    """``fn()``, which must launch ``wrapper``'s kernel once, on
    ``route``."""
    before = dict(wrapper.launches_by_route)
    out = fn()
    delta = {r: n - before[r] for r, n in wrapper.launches_by_route.items()}
    check(delta == {r: int(r == route) for r in delta},
          f"{wrapper.__name__} launched {delta}, expected one launch on "
          f"{route}")
    return out


def kernels_flash(torch, randn, rows):
    """flash_attention at the serving prefill's shape (bf16, causal)
    against its plain version, within tests/test_kernels.py's bf16 limit
    and within FLASH_TIGHT (one bf16 ulp of |want| plus fp32 slack). The
    reference limit must refuse the kernel with its causal mask off and
    with the wrong kv head; the tight one must also refuse the three
    faults of ``flash_faults``, which move only late rows. The same shape
    in fp32 on its own route, timed. Then fp32 and bf16 cases: MQA, head
    dims 64 and 32, non-causal GQA, q_offsets, ragged lengths (Sq = Skv
    = 1000 is no multiple of the bf16 kernel's 128-row tile), and the
    prefill shapes of phases moe (a GQA group of 16), ssm (the reduced
    jamba's 4 heads of 128), vlm (64 heads on 8), gspmd (a rank's 12
    heads on 4, fp32 and bf16) and gspmd_families (a rank's qwen3-moe 32
    heads on 2, fp32 and bf16, and vlm 32 heads on 4). Every bf16
    call must run on the ``wgmma_bf16`` route and every fp32 call on
    ``simt_f32``."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention as kfa
    from repro_torch.kernels import ref

    B, S, H, KV, hd = SERVE_B, SERVE_S, 24, 8, 128
    bf16 = torch.bfloat16
    q, k, v = randn(B, S, H, hd, dtype=bf16), randn(B, S, KV, hd, dtype=bf16), \
        randn(B, S, KV, hd, dtype=bf16)
    atol = FLASH_ATOL["bfloat16"]
    got = on_route(kfa.flash_attention, "wgmma_bf16",
                   lambda: kfa.flash_attention(q, k, v, causal=True))
    want = ref.flash_attention(q, k, v, causal=True)
    ok, err = allclose(torch, got, want, FLASH_RTOL, atol)
    check(ok, f"flash_attention disagrees with its plain version at the "
              f"serving shape: {err}")
    ok, _ = allclose(torch, got, want, FLASH_TIGHT["rtol"],
                     FLASH_TIGHT["atol"])
    check(ok, f"flash_attention differs from its plain version by more than "
              f"one bf16 rounding at the serving shape: {err}")
    # the reference limit must refuse a kernel without its mask or on the
    # wrong head
    ok_full, err_full = allclose(torch, kfa.flash_attention(q, k, v,
                                                            causal=False),
                                 want, FLASH_RTOL, atol)
    ok_head, err_head = allclose(torch, kfa.flash_attention(
        q, k.roll(1, dims=2), v.roll(1, dims=2), causal=True), want,
        FLASH_RTOL, atol)
    check(not ok_full and not ok_head,
          f"flash_attention's limit passes a kernel without the causal mask "
          f"({err_full}) or on the wrong kv head ({err_head})")
    rejects = {"causal_off_max_abs_err": err_full,
               "wrong_kv_head_max_abs_err": err_head}
    # the tight limit must also refuse faults that move only late rows
    for fault, bad in flash_faults(kfa, got, q, k, v).items():
        ok_tight, err_fault = allclose(torch, bad, want, FLASH_TIGHT["rtol"],
                                       FLASH_TIGHT["atol"])
        check(not ok_tight, f"flash_attention's tight limit passes the "
                            f"fault {fault} ({err_fault})")
        rejects[f"{fault}_max_abs_err"] = err_fault
        rejects[f"{fault}_within_reference_limit"] = allclose(
            torch, bad, want, FLASH_RTOL, atol)[0]
        del bad
    del got, want
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, out, k, v
    flops = flash_flops(B, H, S, S, hd, True)
    bms16, by16 = bound(nbytes, flops, BF16_TENSOR_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = cuda_ms(torch, lambda: kfa.flash_attention(q, k, v), iters=20)
    rows["flash_attention"] = dict(
        shape=f"q({B},{S},{H},{hd}) k,v({B},{S},{KV},{hd}) bf16 causal",
        kernel_route="wgmma_bf16", max_abs_err=err,
        tol={"atol": atol, "rtol": FLASH_RTOL},
        tight_tol=FLASH_TIGHT, limit_rejects=rejects, ms=ms,
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(q, k, v),
                         iters=3, warmup=1),
        bound_ms=bms16, bound_by=by16, bound_peak="bf16 tensor cores",
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), bf16")
    del qt, kt, vt
    # the fp32 route at the same shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    del q, k, v
    got = on_route(kfa.flash_attention, "simt_f32",
                   lambda: kfa.flash_attention(q32, k32, v32))
    want = ref.flash_attention(q32, k32, v32)
    ok, err32 = allclose(torch, got, want, FLASH_RTOL, FLASH_ATOL["float32"])
    check(ok, f"flash_attention fp32 disagrees with its plain version at the "
              f"serving shape: {err32}")
    del got, want
    qt, kt, vt = q32.transpose(1, 2), k32.transpose(1, 2), v32.transpose(1, 2)
    bms32, by32 = bound(2 * nbytes, flops)
    simt = dict(
        shape=f"q({B},{S},{H},{hd}) k,v({B},{S},{KV},{hd}) fp32 causal",
        kernel_route="simt_f32", max_abs_err=err32,
        tol={"atol": FLASH_ATOL["float32"], "rtol": FLASH_RTOL},
        ms=cuda_ms(torch, lambda: kfa.flash_attention(q32, k32, v32),
                   iters=10),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(q32, k32, v32),
                         iters=3, warmup=1),
        bound_ms=bms32, bound_by=by32, bound_peak="fp32 pipes",
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), fp32")
    simt.update(bound_share=bms32 / simt["ms"],
                ms_over_library=simt["ms"] / simt["library_ms"])
    emit({"phase": "kernels.flash", "gflop": flops / 1e9,
          "mma_gflop_split_p": 1.5 * flops / 1e9,
          "bound_bf16_tensor_ms": bms16,
          "tflops": flops / ms / 1e9,
          "mma_tflops": 1.5 * flops / ms / 1e9,
          "bf16_tensor_bound_share": bms16 / ms})
    rows["flash_attention"]["simt_f32"] = simt
    del q32, k32, v32, qt, kt, vt
    torch.cuda.empty_cache()
    checked = []
    f32 = torch.float32
    cases = {  # B, Sq, Skv, H, KV, hd, dtype, causal, q_offset
        "fp32 GQA 3:1 hd128 causal": (2, 1024, 1024, 24, 8, 128, f32, True, 0),
        "MQA hd32 causal": (2, 96, 96, 8, 1, 32, f32, True, 0),
        "GQA 4:1 hd64 non-causal": (1, 256, 256, 8, 2, 64, f32, False, 0),
        "MHA hd32 bf16 causal": (2, 128, 128, 4, 4, 32, bf16, True, 0),
        "q_offset 896 hd128 bf16": (2, 128, 1024, 24, 8, 128, bf16, True, 896),
        "ragged 100x200 hd64 q_offset 100": (1, 100, 200, 6, 3, 64, f32, True,
                                             100),
        "ragged 100x200 hd64 q_offset 100 bf16": (1, 100, 200, 6, 3, 64, bf16,
                                                  True, 100),
        "1000x1000 hd128 bf16 causal": (2, 1000, 1000, 24, 8, 128, bf16, True,
                                        0),
        "GQA 4:1 hd64 bf16 non-causal": (1, 256, 256, 8, 2, 64, bf16, False,
                                         0),
        # the MoE and hybrid prefills: qwen3-moe's GQA group of 16 and the
        # reduced jamba's 4 heads of 128 (phases moe and ssm)
        "GQA 16:1 hd128 bf16 causal": (SERVE_B, SERVE_S, SERVE_S, 64, 4, 128,
                                       bf16, True, 0),
        "jamba reduced MHA 4 heads hd128 bf16 causal": (SERVE_B, SERVE_S,
                                                        SERVE_S, 4, 4, 128,
                                                        bf16, True, 0),
        # the vlm prefill (phase vlm): 64 q heads on 8 kv heads
        "vlm GQA 8:1 hd128 bf16 causal": (SERVE_B, SERVE_S, SERVE_S, 64, 8,
                                          128, bf16, True, 0),
        # a rank's head shard in phase gspmd's tensor-parallel prefills on
        # the 2x2 mesh: its rows, 12 q heads on 4 kv heads
        "gspmd rank 12 q on 4 kv heads hd128 causal": (
            GSPMD_PREFILL_B // 2, SERVE_S, SERVE_S, 12, 4, 128, f32, True,
            0),
        "gspmd rank 12 q on 4 kv heads hd128 bf16 causal": (
            SERVE_B // 2, SERVE_S, SERVE_S, 12, 4, 128, bf16, True, 0),
        # a rank's head shard in phase gspmd_families' prefills on the 2x2
        # mesh: qwen3-moe's 32 q heads on 2 kv heads (fp32 and bf16), the
        # vlm's 32 on 4
        "gspmd_families qwen3-moe rank 32 q on 2 kv heads hd128 causal": (
            FAM_DIMS["prefill_b"] // 2, SERVE_S, SERVE_S, 32, 2, 128, f32,
            True, 0),
        "gspmd_families qwen3-moe rank 32 q on 2 kv heads hd128 bf16 "
        "causal": (SERVE_B // 2, SERVE_S, SERVE_S, 32, 2, 128, bf16, True,
                   0),
        "gspmd_families vlm rank 32 q on 4 kv heads hd128 bf16 causal": (
            FAM_DIMS["prefill_b"] // 2, SERVE_S, SERVE_S, 32, 4, 128, bf16,
            True, 0)}
    # the plain version keeps the reference's rule that its blocks divide
    # the lengths: 1000 is no multiple of its default 512, so one block
    plain_blocks = {"1000x1000 hd128 bf16 causal": dict(bq=1000, bk=1000)}
    for label, (b, sq, skv, h, kv, d, dt, causal, qo) in cases.items():
        x = randn(b, sq, h, d, dtype=dt)
        y, z = randn(b, skv, kv, d, dtype=dt), randn(b, skv, kv, d, dtype=dt)
        tol = FLASH_ATOL["float32" if dt == f32 else "bfloat16"]
        route = "simt_f32" if dt == f32 else "wgmma_bf16"
        got = on_route(kfa.flash_attention, route,
                       lambda: kfa.flash_attention(x, y, z, causal=causal,
                                                   q_offset=qo))
        want = ref.flash_attention(x, y, z, causal=causal, q_offset=qo,
                                   **plain_blocks.get(label, {}))
        ok, err = allclose(torch, got, want, FLASH_RTOL, tol)
        check(ok, f"flash_attention disagrees with its plain version: "
                  f"{label}: {err}")
        if dt == bf16:
            ok, _ = allclose(torch, got, want, FLASH_TIGHT["rtol"],
                             FLASH_TIGHT["atol"])
            check(ok, f"flash_attention differs from its plain version by "
                      f"more than one bf16 rounding: {label}: {err}")
        checked.append(f"flash_attention {label}: {route}, max_abs_err "
                       f"{err:.3g} <= {tol:g} + {FLASH_RTOL:g}|want|")
    return checked


def model_bucket_bytes(n: int) -> int:
    """The bucket ``allreduce_tree`` takes by default on a ring of ``n``:
    the cost model's, derived from the H100 model's loopback constants."""
    from repro_torch.comm.autotune import derive_bucket_bytes
    from repro_torch.comm.topology import AxisTopology

    return derive_bucket_bytes((AxisTopology("x", n, "ring"),))


def layer_hop_chunks(n: int, bucket_bytes=None):
    """Elements per ring hop of each bucket of one SERVE_ARCH layer's
    gradient on a ring of ``n`` (the model's buckets unless given)."""
    from repro_torch.benchmarks.overlap_bench import hop_chunks, layer_shapes
    from repro_torch.configs import get_config

    return hop_chunks(layer_shapes(get_config(SERVE_ARCH)),
                      bucket_bytes or model_bucket_bytes(n), n)


def kernels_ring(torch, randn, rows):
    """ring_add_step at the allreduce phase's largest hop chunk, bit for bit
    with its plain version; then at 2^21 fp32 (a 32 MiB bucket's chunk,
    which the L2 holds), at 2^28 fp32 and bf16, into ``out = acc``, on a
    misaligned
    view (the scalar path) and, through ``fused_chunk_add``, ragged fp32
    and fp16 chunks, which launch the kernel once each. Then the kernel's
    and ``torch.add``'s device time alone at every hop chunk of the
    allreduce phase and at 2^21."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring as kring

    chunks = layer_hop_chunks(ALLREDUCE_RANKS)
    hop = max(chunks)
    bf16 = torch.bfloat16
    cases = {"largest hop chunk": (hop, torch.float32, 200),
             "2^21 fp32 (L2)": (1 << 21, torch.float32, 500),
             "2^28 fp32 (HBM)": (1 << 28, torch.float32, 20),
             "2^28 bf16 (HBM)": (1 << 28, bf16, 20)}
    shapes = {}
    for label, (n, dt, iters) in cases.items():
        a, b = randn(n // 128, 128, dtype=dt), randn(n // 128, 128, dtype=dt)
        want = ref.ring_add_step(a, b)
        check(bitwise(torch, kring.ring_add_step(a, b), want),
              f"ring_add_step differs from its plain version: {label}")
        acc = a.clone()
        kring.ring_add_step(acc, b, out=acc)
        check(bitwise(torch, acc, want),
              f"ring_add_step into out=acc differs: {label}")
        size = a.element_size()
        bms, by = bound(3 * size * n, n)
        shapes[label] = dict(
            shape=f"({n // 128},128) {str(dt)[6:]}",
            max_abs_err=max_abs(acc, want), tol="bitwise",
            ms=cuda_ms(torch, lambda: kring.ring_add_step(a, b), iters=iters),
            ms_in_place=cuda_ms(torch, lambda: kring.ring_add_step(
                acc, b, out=acc), iters=iters),
            plain_ms=cuda_ms(torch, lambda: ref.ring_add_step(a, b),
                             iters=max(iters // 4, 5)),
            bound_ms=bms, bound_by=by,
            library_ms=cuda_ms(torch, lambda: torch.add(a, b), iters=iters),
            library="torch.add(acc, recv)")
        if 3 * size * n <= 50e6:
            shapes[label]["note"] = ("three arrays of %.1f MB fit the 50 MB "
                                     "L2: the HBM bound does not bind, and "
                                     "ms is no reading against it"
                                     % (size * n / 1e6))
        del a, b, want, acc
        torch.cuda.empty_cache()
    rows["ring_add_step"] = shapes["largest hop chunk"]
    checked = []
    m = 128 * 4099
    big = randn(2 * m + 3)
    x, y = big[1:1 + m].view(-1, 128), big[m + 2:2 + 2 * m].view(-1, 128)
    check(bitwise(torch, kring.ring_add_step(x, y), ref.ring_add_step(x, y)),
          "ring_add_step differs on misaligned operands")
    checked.append("ring_add_step misaligned 128x4099: bitwise")
    for dt in (torch.float32, torch.float16):
        r1, r2 = randn(128 * 1000 + 37, dtype=dt), randn(128 * 1000 + 37,
                                                       dtype=dt)
        before = kring.ring_add_step.launches
        out = kring.fused_chunk_add(r1, r2)
        check(kring.ring_add_step.launches == before + 1,
              f"fused_chunk_add did not launch the kernel once for a ragged "
              f"{dt} chunk")
        check(bitwise(torch, out, ref.ring_add_step(r1, r2)),
              f"fused_chunk_add differs from its plain version on a ragged "
              f"{dt} chunk")
        checked.append(f"fused_chunk_add ragged 128000+37 {str(dt)[6:]}: "
                       "1 launch, bitwise")
    # device time alone: at the L2-resident sizes the CUDA events of
    # back-to-back calls also hold the wrapper's host time
    device = {}
    for n in sorted(set(chunks) | {1 << 21}):
        a, b = randn(n // 128, 128), randn(n // 128, 128)
        device[n] = dict(
            ring_add_step_ms=queued_ms(
                torch, lambda: kring.ring_add_step(a, b, out=a), 200),
            torch_add_ms=queued_ms(
                torch, lambda: torch.add(a, b, out=a), 200),
            events_ms=cuda_ms(
                torch, lambda: kring.ring_add_step(a, b, out=a), 200),
            bound_ms=bound(12 * n, n)[0])
    emit({"phase": "kernels.ring", "shapes": shapes, "hop_chunks": chunks,
          "device_ms_in_place_fp32": device})
    return checked


def phase_hpl(torch):
    from repro_torch.core.hpl import run_hpl
    from repro_torch.kernels import ops

    nb = N_MAIN // B_MAIN
    reps = 2
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_hpl(n=N_MAIN, b=B_MAIN, reps=reps, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = ops.launches_by_route()
    per_fact = res.details["launches"]
    check(res.error < 1.0, f"HPL residual {res.error} >= 1")
    for name in ops.KERNELS:
        want = nb if name in ops.HPL_KERNELS else 0
        check(per_fact[name] == want and counts[name] == want * (reps + 1),
              f"{name} launched {counts[name]} times in {reps + 1} "
              f"factorizations, expected {want} each")
    for name, route in HPL_ROUTES.items():
        want = {r: nb * (reps + 1) * (r == route) for r in routes[name]}
        check(routes[name] == want,
              f"{name} launched {routes[name]} by route, expected {want}")
    emit({"phase": "hpl", "n": N_MAIN, "b": B_MAIN, "gflops": res.metric,
          "seconds": res.times["best"], "residual": res.error,
          "residual_as_recorded": res.error == HPL_RESIDUAL,
          "factorizations": reps + 1, "launches": counts,
          "launches_by_route": {k: routes[k] for k in HPL_ROUTES},
          "launches_per_factorization": per_fact, "wall_s": wall,
          "device": res.details["device"],
          "schedule": res.details["schedule"]})
    return counts, per_fact, res


def phase_lookahead(torch):
    from repro_torch.core.hpl import generate_system, make_factorize
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    n, b = N_LOOKAHEAD, B_MAIN
    nb = n // b
    a = torch.from_numpy(generate_system(n)[0]).cuda()
    mesh = single_rank_mesh()
    eager = make_factorize(mesh, pg=1, nb=nb, b=b)(a)
    out = {}
    for d in (1, 2):
        ops.reset_launch_counts()
        lu = make_factorize(mesh, pg=1, nb=nb, b=b, lookahead=d)(a)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        bits = int((lu.view(torch.int32) != eager.view(torch.int32)).sum())
        check(torch.equal(lu, eager) and bits == 0,
              f"lookahead d={d} differs from eager in {bits} entries")
        want = dict.fromkeys(ops.KERNELS, 0)
        want.update(lookahead_launches(nb, d))
        check(counts == want, f"lookahead d={d} launches {counts}, "
                              f"expected {want}")
        routes = ops.launches_by_route()
        for name, route in HPL_ROUTES.items():
            check(routes[name][route] == nb + d,
                  f"lookahead d={d}: {name} launched {routes[name]} by "
                  f"route, expected {nb + d} on {route}")
        out[f"d{d}"] = {"bitwise_equal": True, "launches": counts}
    emit({"phase": "lookahead", "n": n, "b": b, **out})


def phase_ptrans(torch):
    """PTRANS at n = 16384 on the 1x1 grid through ``run_ptrans``; then the
    4-strip pipeline against the monolithic step, bit for bit."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.core.ptrans import make_inputs, make_step, run_ptrans
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    n, b, reps = N_PTRANS, B_PTRANS, 3
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_ptrans(n=n, b=b, reps=reps, nchunks=1, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(res.error == 0.0, f"PTRANS error {res.error} != 0 against B + A^T")
    for name in ops.KERNELS:
        want = 1 if name == "transpose_add" else 0
        check(res.details["launches"][name] == want
              and counts[name] == want * (reps + 1),
              f"PTRANS launched {name} {counts[name]} times in {reps + 1} "
              f"steps, expected {want} each")
    t = res.times["best"]

    a, bm, a_loc, b_loc = make_inputs(n, b, 1, "cuda")
    mesh = single_rank_mesh()
    eng = CollectiveEngine.for_mesh(mesh)
    outs, per_step = {}, {}
    for k in (1, 4):
        before = ops.launch_counts()["transpose_add"]
        outs[k] = make_step(mesh, 1, eng, nchunks=k)(a_loc, b_loc)
        per_step[k] = ops.launch_counts()["transpose_add"] - before
    check(per_step == {1: 1, 4: 4},
          f"transpose_add launches per step {per_step}, expected 1 and 4")
    check(bitwise(torch, outs[4], outs[1]),
          "PTRANS nchunks=4 differs from nchunks=1")
    host = torch.from_numpy(bm + a.T)
    check(bitwise(torch, outs[1].cpu(), host),
          "PTRANS step differs from B + A^T on the host")
    del outs, a_loc, b_loc, host
    torch.cuda.empty_cache()
    emit({"phase": "ptrans", "n": n, "b": b, "error": res.error,
          "seconds": t, "gflops": res.metric,
          "gbytes_per_s": 3 * n * n * 4 / t / 1e9,
          "hbm_share": 3 * n * n * 4 / t / HBM_BYTES_PER_S,
          "steps": reps + 1, "launches": counts,
          "launches_per_step": {"nchunks=1": per_step[1],
                                "nchunks=4": per_step[4]},
          "nchunks4_bitwise_equal_nchunks1": True, "wall_s": wall,
          "schedule": res.details["schedule"],
          "device": res.details["device"]})
    return counts


def phase_beff(torch):
    """b_eff on the single-rank ring: no wire, so every exchange is the
    identity; the byte check must pass and the buffers stay on the card."""
    from repro_torch.core.beff import run_beff
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = run_beff(max_log=20, rounds=4, device="cuda")
    counts = ops.launch_counts()
    check(res.error == 0.0, f"b_eff byte check failed ({res.error} sizes)")
    check(res.details["ranks"] == 1, f"b_eff ranks {res.details['ranks']}")
    check(res.details["buffer_device"].startswith("cuda"),
          f"b_eff buffers on {res.details['buffer_device']}")
    check(all(v == 0 for v in counts.values()),
          f"b_eff launched kernels: {counts}")
    emit({"phase": "beff", "max_log": 20, "rounds": 4, "error": res.error,
          "ranks": res.details["ranks"], "b_eff_B_per_s": res.metric,
          "what_it_measures": "host loop overhead: one rank, no wire",
          "schedule": res.details["schedule"],
          "buffer_device": res.details["buffer_device"]})


def phase_stream(torch):
    from repro_torch.core.stream import run_stream
    from repro_torch.kernels import ops

    reps = 3
    ops.reset_launch_counts()
    res = run_stream(elems_per_device=STREAM_ELEMS, reps=reps,
                     device="cuda")
    counts = ops.launch_counts()
    check(res.error == 0.0, f"STREAM error {res.error} != 0")
    for name in ops.KERNELS:
        want = reps + 1 if name in ops.STREAM_KERNELS else 0
        check(counts[name] == want,
              f"STREAM launched {name} {counts[name]} times, expected {want}")
    bw = res.details["bandwidth"]
    torch.cuda.empty_cache()
    emit({"phase": "stream", "elems": STREAM_ELEMS, "error": res.error,
          "bandwidth_B_per_s": bw,
          "hbm_share": {k: v / HBM_BYTES_PER_S for k, v in bw.items()},
          "seconds": res.times, "launches": counts,
          "device": res.details["device"]})
    return counts


def phase_gemm(torch):
    from repro_torch.core.gemm import run_gemm
    from repro_torch.kernels import ops

    m, reps = M_GEMM, 3
    ops.reset_launch_counts()
    res = run_gemm(m=m, reps=reps, device="cuda")
    counts = ops.launch_counts()
    atol = sum_atol(m, m ** -0.5, m ** -0.5)  # inputs: N(0, 1) / sqrt(m)
    check(res.error <= atol, f"GEMM error {res.error} > {atol} against "
                             "torch.matmul (TF32 off)")
    for name in ops.KERNELS:
        want = reps + 1 if name == "matmul" else 0
        check(counts[name] == want,
              f"GEMM launched {name} {counts[name]} times, expected {want}")
    torch.cuda.empty_cache()
    emit({"phase": "gemm", "m": m, "gflops": res.metric,
          "seconds": res.times["best"], "error": res.error, "tol": atol,
          "fp32_peak_share": res.metric * 1e9 / FP32_FLOPS,
          "launches": counts, "device": res.details["device"]})
    return counts


def phase_cpu(torch):
    from repro_torch.core.hpl import generate_system
    from repro_torch.core.hpl_blocked import lu_blocked

    n, b = N_CPU, B_MAIN
    a = torch.from_numpy(generate_system(n)[0])
    card = lu_blocked(a.cuda(), b).cpu()
    host = lu_blocked(a, b)
    ok, err = allclose(torch, card, host, 1e-4, 1e-3)
    check(ok, f"card LU differs from the plain CPU LU at n={n}: {err}")
    emit({"phase": "cpu", "n": n, "b": b, "max_abs_err": err,
          "tol": {"rtol": 1e-4, "atol": 1e-3}})


def serve_run(torch, model, params, prompts, new: int, mesh, extras=None,
              n_flash=None) -> dict:
    """``generate`` twice (bit-identical, the second timed), then the same
    work step by step: the prefill and each decode step timed apart.
    ``generate`` takes ``params`` as given (it casts them to the compute
    dtype); the timed steps take that cast, made before them. ``extras``
    (``patch_embeds``, ``frames``) go to both, decode without ``frames``.
    Checks the output's shape, the prompts, the vocabulary, and that the
    flash kernel ran ``n_flash`` times (default: once per attention layer)
    in every prefill, all on the route of the dtype, and never in decode,
    with no other kernel launched."""
    from repro_torch.kernels import attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import cast_params, dtype_of
    from repro_torch.train.serve import (generate, make_decode_step,
                                         make_prefill_step)

    cfg = model.cfg
    B, S = prompts.shape
    extras = extras or {}
    decode_extras = {k: v for k, v in extras.items() if k != "frames"}
    n_attn = sum(k == "attn" for k in cfg.layer_kinds()) if n_flash is None \
        else n_flash
    route = "wgmma_bf16" if cfg.dtype == "bfloat16" else "simt_f32"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(model, params, prompts, max_new_tokens=new, mesh=mesh,
                   extras=extras)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = dict(kfa.flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(ops.KERNELS, 0)
    want["flash_attention"] = n_attn
    check(counts == want, f"{cfg.name}: generate launched {counts}, "
                          f"expected one flash launch per attention layer "
                          f"({n_attn}) and nothing else")
    want_routes = dict.fromkeys(routes, 0)
    want_routes[route] = n_attn
    check(routes == want_routes, f"{cfg.name}: flash launches by route "
                                 f"{routes}, expected {want_routes}")
    check(tuple(out.shape) == (B, S + new),
          f"{cfg.name}: output shape {tuple(out.shape)}")
    check(torch.equal(out[:, :S], prompts),
          f"{cfg.name}: generate changed the prompts")
    # greedy tokens are the argmax over the padded vocabulary's logits, as
    # in the reference (the LM head is the padded embedding)
    check(bool(((out >= 0) & (out < cfg.padded_vocab())).all()),
          f"{cfg.name}: generated tokens outside the padded vocabulary")
    t0 = time.perf_counter()
    again = generate(model, params, prompts, max_new_tokens=new, mesh=mesh,
                     extras=extras)
    torch.cuda.synchronize()
    generate2_s = time.perf_counter() - t0
    check(torch.equal(again, out), f"{cfg.name}: two greedy runs differ")
    del again

    dtype = dtype_of(cfg.dtype)
    sp = cast_params(params, dtype)  # bf16 weights stay as they are
    cache = model.init_cache(B, S + new, dtype, device=prompts.device)
    prefill, decode = make_prefill_step(model, mesh), make_decode_step(model,
                                                                       mesh)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(sp, {"tokens": prompts, **extras}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_flash = ops.launch_counts()["flash_attention"]
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: prefill logits not finite")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab()),
          f"{cfg.name}: prefill logits {tuple(logits.shape)}")
    tok = torch.argmax(logits[:, -1], dim=-1).to(prompts.dtype)[:, None]
    del logits
    toks, steps = [tok], []
    for _ in range(new - 1):
        t0 = time.perf_counter()
        logits, cache = decode(sp, tok, cache, decode_extras)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name}: decode logits not finite")
        tok = torch.argmax(logits[:, -1], dim=-1).to(prompts.dtype)[:, None]
        toks.append(tok)
    decode_flash = ops.launch_counts()["flash_attention"] - prefill_flash
    check(prefill_flash == n_attn and decode_flash == 0,
          f"{cfg.name}: flash launches: prefill {prefill_flash}, decode "
          f"{decode_flash}")
    check(torch.equal(torch.cat(toks, 1), out[:, S:]),
          f"{cfg.name}: the timed steps differ from generate")
    del cache, sp, logits
    torch.cuda.empty_cache()
    steps.sort()
    p50 = steps[len(steps) // 2]
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "params": cfg.param_count(),
            "batch": B, "prompt_tokens": S, "new_tokens": new,
            "dtype": cfg.dtype, "generate_s": generate_s,
            "generate_s_second_run": generate2_s,
            "generated_tokens_per_s": B * new / generate2_s,
            "prefill_s": prefill_s, "prompt_tokens_per_s": B * S / prefill_s,
            "decode_ms_p50": p50 * 1e3, "decode_ms_min": steps[0] * 1e3,
            "decode_ms_max": steps[-1] * 1e3,
            "decode_tokens_per_s": B / p50, "peak_memory_gb": peak / 1e9,
            "launches": counts,
            "flash_launches": {"prefill": prefill_flash,
                               "decode": decode_flash},
            "flash_launches_by_route": routes, "bitwise_repeat": True}


def phase_serve(torch):
    """llama3.2-3b at full width and depth on the card through the port's
    ``generate`` with the one-rank mesh (the flash path); then the prefill
    and decode steps timed apart, and the fp32 prefill through flash
    against the plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params
    from repro_torch.train.serve import make_prefill_step

    cfg = get_config(SERVE_ARCH)
    B, S, new = SERVE_B, SERVE_S, SERVE_NEW
    dev = torch.device("cuda")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)  # fp32, from a seeded generator
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    mesh = single_rank_mesh(("x",))

    # generate casts the fp32 draw itself, inside its timings; the draw
    # stays for the fp32 prefill below
    served = serve_run(torch, model, params, prompts, new, mesh)
    torch.cuda.empty_cache()

    # fp32 prefill: flash (one-rank mesh) against plain attention (no mesh)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    p1 = prompts[:1]
    lg, prefill_routes = {}, {}
    for label, m, mdl, dt in (("flash", mesh, model32, torch.float32),
                              ("plain", None, model32, torch.float32),
                              ("flash_bf16", mesh, model, torch.bfloat16)):
        c = mdl.init_cache(1, S, dt, device=dev)
        ops.reset_launch_counts()
        lg[label] = make_prefill_step(mdl, m)(cast_params(params, dt),
                                              {"tokens": p1}, c)[0].float()
        prefill_routes[label] = dict(kfa.flash_attention.launches_by_route)
        del c
    n = cfg.num_layers
    check(prefill_routes == {
        "flash": {"wgmma_bf16": 0, "simt_f32": n},
        "plain": {"wgmma_bf16": 0, "simt_f32": 0},
        "flash_bf16": {"wgmma_bf16": n, "simt_f32": 0}},
        f"prefill flash launches by route {prefill_routes}")
    err32 = max_abs(lg["flash"], lg["plain"])
    err_bf16 = max_abs(lg["flash_bf16"], lg["plain"])
    check(bool(torch.isfinite(lg["flash"]).all()), "fp32 logits not finite")
    check(err32 <= FP32_PREFILL_ATOL,
          f"fp32 prefill through flash differs from plain attention by "
          f"{err32} > {FP32_PREFILL_ATOL}")
    check(err_bf16 > FP32_PREFILL_ATOL,
          f"the fp32 limit {FP32_PREFILL_ATOL} passes the bf16 prefill "
          f"({err_bf16})")
    logit_rms = rms(lg["plain"])
    del lg
    torch.cuda.empty_cache()
    emit({"phase": "serve", **served, "init_s": init_s,
          "fp32_prefill": {"batch": 1, "flash_routes": prefill_routes,
                           "max_abs_flash_vs_plain": err32,
                           "atol": FP32_PREFILL_ATOL,
                           "bf16_vs_fp32_max_abs": err_bf16,
                           "logit_rms": logit_rms}})
    return served["launches"]


def phase_allreduce(torch):
    """Four processes on the card reduce one llama3.2-3b layer's gradient
    through ``allreduce_tree``: every schedule exact on integer leaves, rs_ag
    in every bucket mode, and normal leaves through rs_ag bit for bit across
    the ranks and against the plain replay, with the kernel launched as
    often as ``pack_buckets`` says."""
    from repro_torch.benchmarks import overlap_bench as ob
    from repro_torch.comm.engine import schedules_for
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops

    n = ALLREDUCE_RANKS
    cfg = get_config(SERVE_ARCH)
    shapes = ob.layer_shapes(cfg)
    schedules = schedules_for("allreduce")
    runs = [(s, "model", "int8_exact" if s == "int8_ef" else "ints")
            for s in schedules]
    runs += [("rs_ag", m, "ints") for m in ("monolithic", "bucketed",
                                            "leafwise")]
    runs.append(("rs_ag", "model", "normal"))
    # the children only load the libraries, and find the card's memory free
    _build.build()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = ob.run(n, shapes, runs, seed=0, device="cuda",
                     timeout=ALLREDUCE_TIMEOUT)
    wall = time.perf_counter() - t0
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the allreduce phase")
    expected = {}
    table = {}
    for i, (schedule, mode, kind) in enumerate(runs):
        recs = [r[i] for r in results]
        if mode == "model":
            check(all(rec["bucket_bytes"] == model_bucket_bytes(n)
                      for rec in recs),
                  f"{schedule}/model: buckets of "
                  f"{[rec['bucket_bytes'] for rec in recs]} bytes, the cost "
                  f"model derives {model_bucket_bytes(n)}")
        chunks = layer_hop_chunks(n, recs[0]["bucket_bytes"])
        launching = sum(1 for c in chunks if c)
        want = (n - 1) * launching if schedule in (
            "rs_ag", "ring2d", "int8_ef") else 0
        expected[f"{schedule}/{mode}/{kind}"] = want
        for rank, rec in enumerate(recs):
            what = f"{schedule}/{mode}/{kind} rank {rank}"
            check(rec["device"].startswith("cuda"), f"{what} on {rec['device']}")
            check(rec.get("exact", True), f"{what}: not the exact sum")
            check(rec["launches"] == ({"ring_add_step": want} if want else {}),
                  f"{what} launched {rec['launches']}, expected "
                  f"ring_add_step {want}")
            check(rec["staged_bytes"] > 0, f"{what} staged nothing")
            check(rec["buckets"] == len(chunks), f"{what}: {rec['buckets']} "
                  f"buckets, pack_buckets gives {len(chunks)}")
        if kind == "normal":
            check(all(rec["replay_equal"] for rec in recs),
                  f"{schedule}/{mode}: differs from the plain replay of the "
                  "ring's order")
            check(len({rec["digest"] for rec in recs}) == 1,
                  f"{schedule}/{mode}: ranks disagree")
        table[f"{schedule}/{mode}/{kind}"] = dict(
            seconds=max(rec["seconds"] for rec in recs),
            bucket_bytes=recs[0]["bucket_bytes"], buckets=recs[0]["buckets"],
            staged_bytes_per_rank=recs[0]["staged_bytes"],
            ring_add_step_per_rank=recs[0]["launches"].get("ring_add_step", 0))
    main = [r[-1] for r in results]
    launches = main[0]["launches"].get("ring_add_step", 0)
    emit({"phase": "allreduce", "arch": SERVE_ARCH, "ranks": n,
          "transport": "gloo, staged through host memory; kernels on the card",
          "layer_shapes": shapes, "bytes_per_rank": main[0]["bytes"],
          "cut": f"depth only: one of {cfg.num_layers} layers (every layer's "
                 "leaves pack into the same buckets; the whole gradient is "
                 f"{cfg.param_count() * 4 / 1e9:.1f} GB per rank)",
          "bucket_bytes_model": model_bucket_bytes(n),
          "hop_chunks_model": layer_hop_chunks(n),
          "runs": table, "ring_add_step_expected": expected,
          "main_path": "rs_ag/model/normal: bitwise across ranks and with "
                       "the plain replay",
          "wall_s": wall,
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})
    return launches, sum(rec["launches"].get("ring_add_step", 0)
                         for rec in main)


def phase_gups(torch):
    """RandomAccess at full size on one rank through both entry points;
    their forward tables bit for bit; the card's streams against the
    CPU's."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.core import randomaccess as ra
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    kw = dict(table_log=GUPS_TABLE_LOG, rngs_per_device=GUPS_RNGS,
              updates_per_rng=GUPS_UPDATES)
    results, peaks = {}, {}
    ops.reset_launch_counts()
    for name, run in (("drop_local", ra.run_randomaccess),
                      ("routed", ra.run_randomaccess_dist)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = run(**kw, reps=2, device="cuda")
        peaks[name] = torch.cuda.max_memory_allocated()
        check(res.error == 0.0, f"GUPS {name}: restore error {res.error}")
        check(res.details["updates"] == GUPS_RNGS * GUPS_UPDATES,
              f"GUPS {name}: {res.details['updates']} updates")
        results[name] = res
    check(all(v == 0 for v in ops.launch_counts().values()),
          f"GUPS launched hand kernels: {ops.launch_counts()}")

    mesh = single_rank_mesh(("x",))
    table, seeds = ra.from_reference(
        *ra.reference_state(1, table_log=GUPS_TABLE_LOG,
                            rngs_per_device=GUPS_RNGS), mesh, "cuda")
    step_kw = dict(updates_per_rng=GUPS_UPDATES, table_log=GUPS_TABLE_LOG)
    fwd_local = ra.make_step(mesh, **step_kw)(table, seeds)
    fwd_routed = ra.make_routed_step(mesh, CollectiveEngine.for_mesh(mesh),
                                     **step_kw)(table, seeds)
    check(bitwise(torch, fwd_local, fwd_routed),
          "GUPS drop-local and routed forward tables differ on one rank")
    changed = int((fwd_local != table).sum())
    check(changed > 0, "GUPS forward step left the table unchanged")
    sha = bits_sha(fwd_local)
    card = ra.gen_updates(seeds[:64], GUPS_UPDATES).cpu()
    host = ra.gen_updates(seeds[:64].cpu(), GUPS_UPDATES)
    check(torch.equal(card, host), "GUPS streams differ between card and CPU")
    del table, seeds, fwd_local, fwd_routed
    torch.cuda.empty_cache()
    emit({"phase": "gups", "table_log": GUPS_TABLE_LOG,
          "table_bytes": 4 << GUPS_TABLE_LOG,
          "rngs_per_device": GUPS_RNGS, "updates_per_rng": GUPS_UPDATES,
          "updates": results["routed"].details["updates"],
          "gups": {k: r.metric for k, r in results.items()},
          "seconds_best": {k: r.times["best"] for k, r in results.items()},
          "seconds_by_phase": {k: r.details["phase_seconds"]
                               for k, r in results.items()},
          "peak_memory_bytes": peaks, "error": 0.0,
          "forward_tables_bitwise_equal": True, "forward_sha": sha,
          "words_changed": changed, "streams_card_equal_cpu": 64,
          "schedule": results["routed"].details["schedule"],
          "reduced": "HPCC's table of half the memory cannot be had: like "
                     "the reference, a step materializes every update and "
                     "its bucket buffer, and the routed step's peak is "
                     f"{peaks['routed'] / (1 << GUPS_TABLE_LOG):.0f} bytes "
                     "per table word; table_log 28 is a 1 GiB table",
          "device": results["routed"].details["device"]})


def phase_fft(torch):
    """Both FFT entry points at full size on one rank; the pencil step
    against the local one, bit for bit; cuFFT's device time."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.core import fft
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    kw = dict(log_size=FFT_LOG, batch_per_device=FFT_BATCH, reps=3,
              device="cuda")
    ops.reset_launch_counts()
    res = {"local": fft.run_fft(**kw),
           "pencil": fft.run_fft_dist(**kw, nchunks=1)}
    check(all(v == 0 for v in ops.launch_counts().values()),
          f"FFT launched hand kernels: {ops.launch_counts()}")
    for name, r in res.items():
        check(r.error < 1e-5, f"FFT {name}: error {r.error} >= 1e-5")
    n = 1 << FFT_LOG
    x = fft.make_signals(FFT_BATCH, n, device="cuda")
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    local = fft.fft_local(x)
    check(bitwise(torch, fft.make_dist_step(eng)(x), local),
          "FFT pencil step differs from the local transform on one rank")
    check(bitwise(torch, fft.make_dist_step(eng, nchunks=4)(x), local),
          "FFT pencil step (nchunks=4) differs from the local transform")
    ms = cuda_ms(torch, lambda: fft.fft_local(x), iters=10)
    nbytes = 2 * x.numel() * x.element_size()
    flops = 5.0 * n * math.log2(n) * FFT_BATCH
    bound_ms, bound_by = bound(nbytes, flops)
    del x, local
    torch.cuda.empty_cache()
    emit({"phase": "fft", "log_size": FFT_LOG, "batch": FFT_BATCH,
          "bytes": nbytes // 2,
          "gflops": {k: r.metric for k, r in res.items()},
          "seconds_best": {k: r.times["best"] for k, r in res.items()},
          "error": {k: r.error for k, r in res.items()},
          "pencil_bitwise_equal_local": True, "cufft_ms": ms,
          "cufft_gflops": flops / ms / 1e6, "bound_ms": bound_ms,
          "bound_by": bound_by,
          "schedule": res["pencil"].details["schedule"],
          "device": res["local"].details["device"]})


def a2a_rank(mesh):
    """Runs on every rank of the a2a phase: routed GUPS and the pencil FFT
    through each ``all_to_all_tiles`` schedule and chunking on the card.
    Returns per (op, schedule, nchunks) the entry point's result, the
    bytes staged through the host by one GUPS exchange and one FFT step,
    and digests of what they moved."""
    import torch

    from repro_torch.comm.engine import (CollectiveEngine,
                                         reset_staged_bytes, schedules_for,
                                         staged_bytes)
    from repro_torch.core import fft
    from repro_torch.core import randomaccess as ra

    torch.cuda.set_device(0)
    ax = mesh.axis("x")
    table, seeds = ra.from_reference(
        *ra.reference_state(ax.size, table_log=A2A_TABLE_LOG,
                            rngs_per_device=A2A_RNGS), mesh, "cuda")
    ra_kw = dict(table_log=A2A_TABLE_LOG, updates_per_rng=GUPS_UPDATES)
    n = 1 << FFT_LOG
    ns = n // ax.size
    cols = slice(ax.index * ns, (ax.index + 1) * ns)
    x = fft.make_signals(A2A_FFT_BATCH * ax.size, n, device="cuda")
    x_loc = x[:, cols].contiguous()
    want = torch.cat([fft.fft_local(b.clone())
                      for b in x.chunk(ax.size)])[:, cols]
    buf = ra.bucket_updates(ra.gen_updates(seeds, GUPS_UPDATES).reshape(-1),
                            table_log=A2A_TABLE_LOG,
                            local_size=table.shape[0], n_dev=ax.size,
                            sign=1)
    out = {"buf": bits_sha(buf)}
    for s in schedules_for("all_to_all_tiles"):
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        for k in A2A_CHUNKS:
            res = ra.run_randomaccess_dist(
                mesh, **ra_kw, rngs_per_device=A2A_RNGS, reps=1, schedule=s,
                nchunks=k, device="cuda")
            # the digests come from one exchange of the buckets built above
            # and the routed step's scatter, not from another whole step
            reset_staged_bytes()
            recv = ra.exchange_updates(eng, buf, k)
            fwd = ra.scatter_add(table, recv[..., 0].reshape(-1),
                                 recv[..., 1].reshape(-1))
            out["gups", s, k] = dict(
                error=res.error, gups=res.metric, seconds=res.times["best"],
                seconds_by_phase=res.details["phase_seconds"],
                schedule=res.details["schedule"],
                staged_bytes=staged_bytes(), recv=bits_sha(recv),
                table=bits_sha(fwd), changed=int((fwd != table).sum()))
            res = fft.run_fft_dist(mesh, log_size=FFT_LOG,
                                   batch_per_device=A2A_FFT_BATCH, reps=1,
                                   schedule=s, nchunks=k, device="cuda")
            reset_staged_bytes()
            got = fft.make_dist_step(eng, nchunks=k)(x_loc)
            out["fft", s, k] = dict(
                error=res.error, gflops=res.metric,
                seconds=res.times["best"], schedule=res.details["schedule"],
                staged_bytes=staged_bytes(),
                bitwise_block=bitwise(torch, got, want), out=bits_sha(got))
    return out


def phase_a2a(torch):
    """Routed GUPS and the pencil FFT on four processes sharing the card:
    every schedule and chunking exact, and each rank's results identical
    across them."""
    from repro_torch.comm.engine import schedules_for
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh

    n = A2A_RANKS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = spawn_mesh(n, a2a_rank, axes=("x",), timeout=A2A_TIMEOUT)
    wall = time.perf_counter() - t0
    combos = [(s, k) for s in schedules_for("all_to_all_tiles")
              for k in A2A_CHUNKS]
    # bytes each schedule stages through the host for a payload of P per
    # rank: native copies P out and P back; chain's rounds carry
    # n(n-1)/2 tiles of P/n out and back; staged copies P out and the n
    # gathered payloads back. GUPS stages one exchange, the FFT two.
    times_payload = {"native": 2, "chain": n - 1, "staged": n + 1}
    payload = {"gups": n * A2A_RNGS * GUPS_UPDATES * 2 * 4,
               "fft": 2 * A2A_FFT_BATCH * (1 << FFT_LOG) * 8}
    table = {}
    for op in ("gups", "fft"):
        for s, k in combos:
            recs = [r[op, s, k] for r in results]
            what = f"a2a {op} {s} nchunks={k}"
            check(all(r["schedule"] == s for r in recs),
                  f"{what}: resolved {[r['schedule'] for r in recs]}")
            want = times_payload[s] * payload[op]
            check(all(r["staged_bytes"] == want for r in recs),
                  f"{what}: staged {[r['staged_bytes'] for r in recs]} "
                  f"bytes per rank, not {want}")
            if op == "gups":
                check(all(r["error"] == 0.0 for r in recs),
                      f"{what}: restore error {[r['error'] for r in recs]}")
                check(all(r["changed"] > 0 for r in recs),
                      f"{what}: a rank's table did not change")
            else:
                check(all(r["error"] < 1e-5 for r in recs),
                      f"{what}: error {[r['error'] for r in recs]}")
                check(all(r["bitwise_block"] for r in recs),
                      f"{what}: differs from torch.fft.fft at (B/4, n)")
            table[f"{op}/{s}/nchunks={k}"] = dict(
                seconds=max(r["seconds"] for r in recs),
                staged_bytes_per_rank=[r["staged_bytes"] for r in recs],
                **({"gups": recs[0]["gups"],
                    "seconds_by_phase_rank0": recs[0]["seconds_by_phase"]}
                   if op == "gups" else {"gflops": recs[0]["gflops"],
                                         "error": max(r["error"]
                                                      for r in recs)}))
    for rank, r in enumerate(results):
        for key in ("recv", "table"):
            check(len({r["gups", s, k][key] for s, k in combos}) == 1,
                  f"a2a rank {rank}: GUPS {key} differs across schedules")
        check(len({r["fft", s, k]["out"] for s, k in combos}) == 1,
              f"a2a rank {rank}: FFT output differs across schedules")
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the a2a phase")
    emit({"phase": "a2a", "ranks": n,
          "transport": "gloo, staged through host memory; compute on the "
                       "card",
          "gups": {"table_log": A2A_TABLE_LOG, "rngs_per_rank": A2A_RNGS,
                   "updates_per_rng": GUPS_UPDATES,
                   "exchange_bytes_per_rank": payload["gups"]},
          "fft": {"log_size": FFT_LOG, "batch_per_rank": A2A_FFT_BATCH,
                  "exchange_bytes_per_rank": payload["fft"] // 2},
          "staged_bytes_times_payload": times_payload,
          "cut": "depth only: the gups and fft phases run full size on one "
                 "rank; here four ranks share one card and the host",
          "runs": table, "restore_exact": True,
          "fft_bitwise_block_shape": True,
          "identical_across_schedules": ["received buckets", "tables",
                                         "fft output"],
          "wall_s": wall,
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})


def lookahead_launches(nb: int, d: int) -> dict:
    """Kernel launches of one depth-``d`` factorization of ``nb`` blocks:
    the prologue's d panel sets, then per iteration the bulk update, one
    panel set and 2d strip updates (none at d = 0)."""
    if d == 0:
        return {"gemm_update": nb, "lu_factor_block": nb,
                "trsm_lower_left": nb, "trsm_upper_right": nb}
    return {"gemm_update": d * (d - 1) + nb * (2 * d + 1),
            "lu_factor_block": nb + d, "trsm_lower_left": nb + d,
            "trsm_upper_right": nb + d}


def phase_autotune(torch, rows):
    """The cost model and autotuner on the card: HPL with lookahead="auto"
    at the main size, bit for bit the integer depth the model chose (and
    eager); the one-card section of hpl_scaling; the loopback's link
    constants on four gloo processes; the quick measured autotune and the
    --autotune gate on a ring of four. Its two-size table goes to a
    temporary directory, so the checkout's results/tuning_torch.json and
    the process's default model stay as they were."""
    import dataclasses
    import tempfile

    from repro_torch.benchmarks import hpl_scaling, hw_model
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.comm import autotune
    from repro_torch.comm.topology import AxisTopology
    from repro_torch.comm.types import H100_80GB
    from repro_torch.core.hpl import generate_system, make_factorize, run_hpl
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    t0 = time.perf_counter()
    nb = N_MAIN // B_MAIN
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = run_hpl(n=N_MAIN, b=B_MAIN, reps=1, lookahead="auto",
                  device="cuda")
    counts = ops.launch_counts()
    depth = res.details["lookahead_depth"]
    check(1 <= depth <= autotune.MAX_LOOKAHEAD_DEPTH,
          f"lookahead='auto' ran at depth {depth}")
    check(res.error < 1.0, f"HPL residual {res.error} >= 1 at lookahead "
                           f"'auto' (depth {depth})")
    per_fact = {k: v for k, v in res.details["launches"].items() if v}
    check(per_fact == lookahead_launches(nb, depth),
          f"lookahead 'auto' (depth {depth}) launched {per_fact} per "
          f"factorization, expected {lookahead_launches(nb, depth)}")
    check(counts == {k: 2 * v for k, v in res.details["launches"].items()},
          f"lookahead 'auto' launched {counts} in two factorizations")
    hpl_s = time.perf_counter() - t0

    a = torch.from_numpy(generate_system(N_MAIN)[0]).cuda()
    mesh = single_rank_mesh()
    lu = {la: make_factorize(mesh, pg=1, nb=nb, b=B_MAIN, lookahead=la)(a)
          for la in ("auto", depth, False)}
    check(bitwise(torch, lu["auto"], lu[depth]),
          f"lookahead 'auto' differs from depth {depth}")
    check(bitwise(torch, lu["auto"], lu[False]),
          "lookahead 'auto' differs from eager")
    del a, lu
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    scaling = hpl_scaling.main(quick=True, device="cuda")
    for key, rec in scaling.items():
        if isinstance(rec, dict) and "lookahead_depth" in rec:
            check(rec["err"] is None or rec["err"] < 1.0,
                  f"hpl_scaling {key}: residual {rec['err']}")
            check(rec["gflops"] > 0, f"hpl_scaling {key}: no rate")
    check(len(scaling["extrapolation"]) == len(hpl_scaling.DEVICES),
          "hpl_scaling: no extrapolation")
    scaling_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    links = hw_model.link_constants(timeout=AUTOTUNE_TIMEOUT)
    links_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    default = autotune.default_cost_model()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tuning_torch.json"
        gate = bench_run.autotune_gate(True, device="cuda", path=path,
                                       timeout=AUTOTUNE_TIMEOUT)
        check(gate["path"] == str(path)
              and autotune.TuningTable.load(path).to_json() == gate["table"],
              f"the gate's table was not saved to {path}")
    table = gate["table"]
    check(table["meta"]["device"] == "cuda"
          and table["meta"]["backend"] == "gloo",
          f"tuning table measured on {table['meta']}")
    check(set(table["entries"]) == set(autotune.table_keys()),
          f"tuning table holds {sorted(table['entries'])}")
    check(autotune.default_cost_model() is default,
          "the smoke's table replaced the process's default model")
    gate_s = time.perf_counter() - t1

    ring = (AxisTopology("x", ALLREDUCE_RANKS, "ring"),)
    measured = {"peak_flops": 2.0 * N_MAIN * N_MAIN * B_MAIN
                / (rows["gemm_update"]["ms"] * 1e-3),
                "hbm_bw": 2.0 * STREAM_ELEMS * 4
                / (rows["stream_copy"]["ms"] * 1e-3)}
    emit({"phase": "autotune", "hw_model": dataclasses.asdict(H100_80GB),
          "measured_in_this_run": {
              "from_phase_kernels": measured,
              "links_loopback": links},
          "hpl": {"n": N_MAIN, "b": B_MAIN, "lookahead": "auto",
                  "depth": depth, "residual": res.error,
                  "gflops": res.metric, "seconds": res.times["best"],
                  "launches_per_factorization": per_fact,
                  "bitwise_equal": [f"depth {depth}", "eager"]},
          "hpl_scaling_quick": scaling,
          "bucket_bytes_ring4": autotune.derive_bucket_bytes(ring),
          "tuning_table": table, "gate": "ok",
          "seconds": {"hpl": hpl_s, "hpl_scaling": scaling_s,
                      "links": links_s, "autotune_gate": gate_s,
                      "phase": time.perf_counter() - t0},
          "what_the_link_times_measure": "the host's loopback (gloo "
                                         "between processes on one "
                                         "machine), not a link rate"})
    return counts


def faults_rank(mesh):
    """Runs on every rank of the faults phase: the link-down section at
    ``failover_bench.DOWN_HOP`` and the train-retune loop, payloads on the
    card."""
    from repro_torch.benchmarks import failover_bench, resilience_bench

    return (failover_bench.link_down_rank(
                mesh, (failover_bench.DOWN_HOP,), "cuda"),
            resilience_bench.train_retune_rank(mesh, "cuda"))


def phase_faults(torch):
    """The fault layer on four processes sharing the card: a severed ring
    hop rerouted and repaired, and the in-run retune under a degraded
    link, both gated, with ``ring_add_step`` launched only on the ring
    route; then the measured retune's quick ladder from this process."""
    from repro_torch.benchmarks import failover_bench as fb
    from repro_torch.benchmarks import resilience_bench as rb
    from repro_torch.comm.engine import schedules_for
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh

    n = fb.RANKS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = spawn_mesh(n, faults_rank, axes=("x",), timeout=FAULTS_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    ld = fb.link_down_record([r[0] for r in results], fb.DOWN_HOP)
    tr = rb.train_retune_record([r[1] for r in results])
    check(ld["device"].startswith("cuda") and tr["device"].startswith("cuda"),
          f"faults ran on {ld['device']} and {tr['device']}")
    bad = fb.gate_link_down(ld)
    check(not bad, f"link-down gate: {bad}")
    bad = rb.gate_train_retune(tr)
    check(not bad, f"train-retune gate: {bad}")
    # the float allreduce's ring_add_step launches per rank: n - 1 per call
    # on the ring route, none on staged
    want = {ph: n - 1 if ld[f"resolved_{ph}"]["allreduce"] in ("ring2d",
                                                                "rs_ag")
            else 0 for ph in fb.PHASES}
    check(want == {"before": n - 1, "during": 0, "after": n - 1},
          f"allreduce resolved {[ld[f'resolved_{ph}'] for ph in fb.PHASES]}"
          ": not the ring route, then staged, then the ring route")
    check(all(ld["ring_add_step_per_rank"][ph] == [want[ph]] * n
              for ph in fb.PHASES),
          f"ring_add_step per rank {ld['ring_add_step_per_rank']}, "
          f"expected {want}")

    t1 = time.perf_counter()
    mr = rb.measured_retune_section(True, "cuda")
    measured_s = time.perf_counter() - t1
    for key in ("clean_winners", "degraded_winners"):
        names = [name for rows in mr[key].values() for _, name in rows]
        check(names and all(nm in schedules_for("bcast") for nm in names),
              f"measured retune {key}: {mr[key]}")
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the faults phase")
    emit({"phase": "faults", "ranks": n, "nbytes_per_rank": fb.NBYTES,
          "transport": "gloo, staged through host memory; payloads on the "
                       "card",
          "link_down": {k: ld[k] for k in (
              "down_hop", "resolved_before", "resolved_during",
              "resolved_after", "route_during", "route_excludes_cut",
              "ranks_agree", "bit_identical", "bcast_correct",
              "allreduce_correct", "ring_add_step_per_rank",
              "recovery_s")},
          "train_retune": {k: tr[k] for k in (
              "beta_scale", "fault_at", "heal_at", "steps", "by_phase",
              "events", "flip_events", "detect_degrade_steps",
              "detect_heal_steps", "ranks_agree", "bit_identical",
              "retune_s")},
          "measured_retune": mr,
          "gates": "ok",
          "seconds": {"ranks": ranks_s, "measured_retune": measured_s,
                      "phase": time.perf_counter() - t0},
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})


def prefill_moe_dropped(torch, model, params, prompts, mesh) -> dict:
    """The fraction of routed slots each MoE layer dropped in one prefill
    of ``prompts`` (the model's own aux collects no MoE metrics, as the
    reference's; ``apply_moe`` is wrapped to pass one). A second count of
    each layer's drops from its routing alone (a per-row histogram of the
    expert ids, less the capacity; no cumsum, no scatter) must equal it.
    Also each layer input's common share: the rms of its per-row token
    mean over its rms (0 for independent tokens, 1 for identical ones)."""
    from repro_torch.models import moe
    from repro_torch.train.serve import make_prefill_step

    rec, orig = {"dropped": [], "recount": [], "common_share": []}, \
        moe.apply_moe

    def spy(p, cfg, x, aux=None, shard=None):
        got = {}
        out = orig(p, cfg, x, aux=got, shard=shard)
        B, S, _ = x.shape
        slots = B * S * cfg.num_experts_per_tok
        _, ids = moe.route(p, cfg, x)
        hist = torch.zeros((B, cfg.num_experts), dtype=torch.int64,
                           device=x.device)
        hist.scatter_add_(1, ids.reshape(B, -1), torch.ones_like(
            ids.reshape(B, -1)))
        over = int((hist - moe._capacity(cfg, S)).clamp(min=0).sum())
        dropped = float(got["moe_dropped"])
        check(round(dropped * slots) == over,
              f"moe_dropped {dropped} of {slots} slots, but the routing's "
              f"histogram overflows the capacity by {over}")
        xf = x.float()
        rec["dropped"].append(dropped)
        rec["recount"].append(over / slots)
        rec["common_share"].append(float(
            (xf.mean(1).square().mean() / xf.square().mean()).sqrt()))
        return out

    moe.apply_moe = spy
    try:
        cache = model.init_cache(prompts.shape[0], prompts.shape[1],
                                 params.embed.dtype, device=prompts.device)
        make_prefill_step(model, mesh)(params, {"tokens": prompts}, cache)
    finally:
        moe.apply_moe = orig
    del cache
    return rec


def moe_ep_rank(mesh):
    """Runs on every rank of the moe phase's expert-parallel section: one
    full-width MoE layer in fp32, each rank holding E / n experts and one
    row. In turn, each rank draws the whole layer (the same seed on every
    rank), runs the single-process ``apply_moe`` on all n rows, and keeps
    its experts; then every rank runs the explicit layer for each
    ``all_to_all_tiles`` schedule and chunk count."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.comm.engine import (reset_staged_bytes, schedules_for,
                                         staged_bytes)
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    torch.cuda.set_device(0)
    torch.set_grad_enabled(False)  # forward only: no autograd graph
    dev = torch.device("cuda")
    ax = mesh.axis("x")
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((ax.size, MOE_LAYER_S, cfg.d_model), generator=gen,
                    device=dev)
    for turn in range(ax.size):
        if turn == ax.index:
            p = moe.init_moe(torch.Generator(device=dev).manual_seed(3), cfg,
                             dev)
            aux = {}
            want = moe.apply_moe(p, cfg, x, aux=aux)[ax.index:ax.index + 1]
            local = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                     for k, v in moe.expert_shard(p, mesh).items()}
            del p
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    x_loc = x[ax.index:ax.index + 1]
    out = {"dropped": float(aux["moe_dropped"]),
           "capacity": moe._capacity(cfg, MOE_LAYER_S),
           "experts_local": int(local["w_gate"].shape[0])}
    for s in schedules_for("all_to_all_tiles"):
        for k in MOE_EP_CHUNKS:
            fn = moe.make_apply_moe_explicit(cfg, mesh, schedule=s,
                                             nchunks=k)
            reset_staged_bytes()
            dist.barrier()
            t0 = time.perf_counter()
            got = fn(local, x_loc)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            out[s, k] = dict(
                seconds=secs, staged_bytes=staged_bytes(),
                max_abs=max_abs(got, want),
                close=allclose(torch, got, want, *MOE_TOL),
                finite=bool(torch.isfinite(got).all()), bits=bits_sha(got))
    return out


def phase_moe(torch):
    """qwen3-moe at full width (MOE_LAYERS layers) served on the one-rank
    mesh; its MoE layer against the dense oracle at full width in fp32;
    and the expert-parallel layer on four processes sharing the card,
    equal to the single-process layer for every schedule and chunking."""
    import dataclasses

    from repro_torch.comm.engine import schedules_for
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = model.init(0, device=dev)  # fp32, from a seeded generator
    params = cast_params(params32, torch.bfloat16)
    del params32  # the serving copy stays: about 21 GB of bf16 weights
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                            generator=gen, device=dev, dtype=torch.int32)
    mesh = single_rank_mesh(("x",))
    served = serve_run(torch, model, params, prompts, SERVE_NEW, mesh)
    routing = prefill_moe_dropped(torch, model, params, prompts, mesh)
    dropped = routing["dropped"]
    check(len(dropped) == MOE_LAYERS and all(0 <= d < 1 for d in dropped),
          f"prefill moe_dropped {dropped}")
    del params
    torch.cuda.empty_cache()

    # the layer alone at full width in fp32, nothing dropped, against the
    # dense oracle
    lcfg = dataclasses.replace(cfg, dtype="float32",
                               capacity_factor=float(cfg.num_experts
                                                     / cfg.num_experts_per_tok))
    check(moe._capacity(lcfg, MOE_LAYER_S) == MOE_LAYER_S,
          "the oracle's capacity does not cover every token")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(3), lcfg, dev)
    x = torch.randn((1, MOE_LAYER_S, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    aux = {}
    with torch.no_grad():
        got = moe.apply_moe(p, lcfg, x, aux=aux)
        want = moe.reference_moe(p, lcfg, x)
    err = max_abs(got, want)
    check(float(aux["moe_dropped"]) == 0.0,
          f"the oracle's layer dropped {float(aux['moe_dropped'])}")
    check(allclose(torch, got, want, *MOE_TOL),
          f"apply_moe against reference_moe at full width: max |diff| "
          f"{err}, rtol/atol {MOE_TOL}")
    layer = {"batch": 1, "seq": MOE_LAYER_S, "dtype": "float32",
             "capacity_factor": lcfg.capacity_factor,
             "capacity": MOE_LAYER_S, "dropped": 0.0,
             "max_abs_vs_reference_moe": err, "rtol_atol": MOE_TOL,
             "out_rms": rms(want)}
    del p, x, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the expert-parallel layer on four processes sharing the card
    n = MOE_EP_RANKS
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = spawn_mesh(n, moe_ep_rank, axes=("x",), timeout=MOE_EP_TIMEOUT)
    ep_s = time.perf_counter() - t0
    combos = [(s, k) for s in schedules_for("all_to_all_tiles")
              for k in MOE_EP_CHUNKS]
    # the dispatch and the combine each move (B_loc, E, C, D) fp32 per rank
    C = results[0]["capacity"]
    payload = 1 * cfg.num_experts * C * cfg.d_model * 4
    times_payload = {"native": 2, "chain": n - 1, "staged": n + 1}
    runs = {}
    for s, k in combos:
        recs = [r[s, k] for r in results]
        what = f"moe expert-parallel {s} nchunks={k}"
        check(all(r["finite"] and r["close"] for r in recs),
              f"{what}: max |diff| from the single-process layer "
              f"{[r['max_abs'] for r in recs]}, rtol/atol {MOE_TOL}")
        staged = 2 * times_payload[s] * payload
        check(all(r["staged_bytes"] == staged for r in recs),
              f"{what}: staged {[r['staged_bytes'] for r in recs]} bytes "
              f"per rank, not {staged}")
        runs[f"{s}/nchunks={k}"] = dict(
            seconds=max(r["seconds"] for r in recs),
            max_abs=max(r["max_abs"] for r in recs),
            staged_bytes_per_rank=[r["staged_bytes"] for r in recs])
    for rank, r in enumerate(results):
        check(len({r[s, k]["bits"] for s, k in combos}) == 1,
              f"moe expert-parallel rank {rank}: the output differs across "
              "schedules and chunk counts")
        check(r["experts_local"] == cfg.num_experts // n,
              f"rank {rank} holds {r['experts_local']} experts")
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the expert-parallel section")
    emit({"phase": "moe", **served, "full_depth_layers": 94,
          "cut": f"depth only: {MOE_LAYERS} of 94 layers at full width "
                 "(random weights, seed 0)",
          "init_s": init_s, "init_peak_memory_gb": init_peak / 1e9,
          "prefill_moe_dropped": dropped,
          "prefill_moe_dropped_recount": routing["recount"],
          "prefill_moe_input_common_share": routing["common_share"],
          "capacity": {"prefill": moe._capacity(cfg, SERVE_S),
                       "decode": moe._capacity(cfg, 1)},
          "layer_vs_reference_moe": layer,
          "expert_parallel": {
              "ranks": n, "experts_per_rank": cfg.num_experts // n,
              "tokens_per_rank": MOE_LAYER_S, "dtype": "float32",
              "capacity": C, "dropped": results[0]["dropped"],
              "exchange_bytes_per_rank": payload,
              "staged_bytes_times_payload": times_payload,
              "runs": runs, "identical_across_schedules": True,
              "rtol_atol": MOE_TOL, "wall_s": ep_s,
              "transport": "gloo, staged through host memory; compute on "
                           "the card",
              "what_the_time_measures": "the host's loopback (gloo on one "
                                        "machine), not a link rate"}})


def phase_ssm(torch):
    """mamba2-130m at full size and jamba cut to HYBRID_LAYERS layers at
    d_model HYBRID_D in bf16, each served on the one-rank mesh."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params

    dev = torch.device("cuda")
    mesh = single_rank_mesh(("x",))
    hybrid = dataclasses.replace(
        reduced(get_config(HYBRID_ARCH), layers=HYBRID_LAYERS,
                d_model=HYBRID_D), dtype="bfloat16")
    records = []
    for label, cfg in (("ssm", get_config(SSM_ARCH)), ("hybrid", hybrid)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        model = build_model(cfg)
        params = cast_params(model.init(0, device=dev), torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                                generator=gen, device=dev, dtype=torch.int32)
        rec = serve_run(torch, model, params, prompts, SERVE_NEW, mesh)
        rec["kinds"] = "".join(k[0] for k in cfg.layer_kinds())
        rec["moe_layers"] = sum(cfg.moe_layer_mask())
        rec["cut"] = ("none: full size (random weights, seed 0)"
                      if label == "ssm" else
                      f"reduced(layers={HYBRID_LAYERS}, d_model={HYBRID_D}) "
                      "in bf16: head_dim 128, 4 experts top-2, vocab 512; "
                      "full width does not fit one card")
        records.append((label, rec))
        del params, model
    emit({"phase": "ssm", **{label: rec for label, rec in records}})


def prefill_card_vs_cpu(torch, cfg, params, batch) -> dict:
    """An fp32 batch-1 prefill of ``cfg`` with fp32 ``params`` on the card
    and the same call on a CPU copy of them, held within FP32_TOL. No mesh:
    both take the plain attention."""
    import dataclasses

    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.train.serve import make_prefill_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    S = batch["tokens"].shape[1]
    logits = {}
    for where in (torch.device("cuda"), torch.device("cpu")):
        p = type(params)(cfg32, tree_map(params.tree(),
                                         lambda t, w=where: t.to(w)))
        cache = model32.init_cache(1, S, torch.float32, device=where)
        b = {k: v[:1].to(where) for k, v in batch.items()}
        logits[where.type] = make_prefill_step(model32, None)(
            p, b, cache)[0].float().cpu()
        del p, cache, b
    err = max_abs(logits["cuda"], logits["cpu"])
    check(bool(torch.isfinite(logits["cuda"]).all())
          and allclose(torch, logits["cuda"], logits["cpu"], *FP32_TOL)[0],
          f"{cfg.name}: fp32 prefill on the card against the CPU: max "
          f"|diff| {err}, rtol/atol {FP32_TOL}")
    return {"batch": 1, "tokens": S, "max_abs": err, "rtol_atol": FP32_TOL,
            "logit_rms": rms(logits["cpu"])}


def phase_vlm(torch):
    """llama-3.2-vision-90b at full width, one period deep: its fp32 prefill
    with patches on the card against the CPU, then served on the one-rank
    mesh with 1024 patches a request; the logits must move when the cross
    gates open."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params

    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    cross = [i for i, c in enumerate(cfg.cross_attn_mask()) if c]
    check(cross == [VLM_LAYERS - 1], f"vlm cross layers {cross}")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = model.init(0, device=dev)  # fp32, from a seeded generator
    # the reference's gates start at 0 (tanh(0) hides the cross branch):
    # open them to values drawn from the seed
    gates = torch.rand(len(cross), generator=torch.Generator().manual_seed(
        VLM_GATE_SEED)) * 0.5 + 0.5
    for i, g in zip(cross, gates.tolist()):
        params32.blocks[i]["cross_gate"].data.fill_(g)
    params = cast_params(params32, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                            generator=gen, device=dev, dtype=torch.int32)
    patches = torch.randn((SERVE_B, cfg.num_patches, cfg.vision_dim),
                          generator=gen, device=dev)
    # the cross layer on the card against the CPU, on the fp32 weights
    witness = prefill_card_vs_cpu(torch, cfg, params32, {
        "tokens": prompts[:1, :VLM_WITNESS_S], "patch_embeds": patches[:1]})
    del params32  # the serving copy stays: about 11 GB of bf16 weights
    torch.cuda.empty_cache()
    mesh = single_rank_mesh(("x",))
    served = serve_run(torch, model, params, prompts, SERVE_NEW, mesh,
                       extras={"patch_embeds": patches})

    # the cross branch must matter: one request's logits with the gates
    # set and with them closed
    with torch.no_grad():
        batch = {"tokens": prompts[:1], "patch_embeds": patches[:1]}
        opened = model.apply(params, batch)[0].float()
        for i in cross:
            params.blocks[i]["cross_gate"].data.zero_()
        closed = model.apply(params, batch)[0].float()
    gate_moves = max_abs(opened, closed)
    check(bool(torch.isfinite(opened).all()) and gate_moves > 0,
          f"vlm: the logits with the cross gates open and closed differ "
          f"by {gate_moves}")
    del opened, closed, params
    torch.cuda.empty_cache()
    # one decode step recomputes the cross K/V of every patch: the patch
    # projection and the cross layers' k and v projections
    cross_kv_flop = 2 * SERVE_B * cfg.num_patches * cfg.d_model * (
        cfg.vision_dim + len(cross) * 2 * cfg.num_kv_heads * cfg.head_dim)
    emit({"phase": "vlm", **served, "full_depth_layers": 100,
          "cut": f"depth only: {VLM_LAYERS} of 100 layers (one period, the "
                 "cross layer last) at full width (random weights, seed 0)",
          "cross_layers": cross, "cross_gates": gates.tolist(),
          "patches": [SERVE_B, cfg.num_patches, cfg.vision_dim],
          "init_s": init_s, "init_peak_memory_gb": init_peak / 1e9,
          "gate_open_vs_closed_max_abs": gate_moves,
          "fp32_prefill_vs_cpu": witness,
          "decode_cross_kv_tflop": cross_kv_flop / 1e12})


def phase_whisper(torch):
    """whisper-base at full size served on the one-rank mesh (no path of
    the encoder-decoder takes the flash kernel), then its fp32 batch-1
    prefill on the card against the same call on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model

    cfg = get_config(WHISPER_ARCH)
    dev = torch.device("cuda")
    model = build_model(cfg)
    params = model.init(0, device=dev)  # fp32, from a seeded generator
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, WHISPER_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    frames = torch.randn((SERVE_B, cfg.audio_ctx, cfg.d_model),
                         generator=gen, device=dev)
    served = serve_run(torch, model, params, prompts, SERVE_NEW, mesh=
                       single_rank_mesh(("x",)), extras={"frames": frames},
                       n_flash=0)

    witness = prefill_card_vs_cpu(torch, cfg, params, {
        "tokens": prompts[:1], "frames": frames[:1]})
    emit({"phase": "whisper", **served, "frames": list(frames.shape),
          "cut": "none: full size (random weights, seed 0)",
          "fp32_prefill_vs_cpu": witness})
    del params, frames
    torch.cuda.empty_cache()


def engine_run(torch, model, params, prompts, pcfg) -> dict:
    """One ``ServeEngine.run`` over ``prompts`` on a fresh pool: the
    streams, per-step stats, wall seconds, launches and peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, pcfg, dtype=torch.bfloat16)
    out, stats = eng.run(prompts, max_new_tokens=SERVE_NEW,
                         collect_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"out": out, "stats": stats, "wall_s": wall,
            "launches": ops.launch_counts(),
            "peak": torch.cuda.max_memory_allocated()}


def paged_vs_dense(torch, cfg, params32, prompts, pcfg, new: int) -> dict:
    """The paged decode held against the dense model: ``prompts`` through
    an fp32 ``ServeEngine`` on ``params32``'s device, recording every
    decode step's logits row of each active slot; then each request's
    final sequence goes once through the model without a cache, and the
    row of the step that fed position L must match the dense logits at L
    within FP32_TOL. A wrong page gather or token scatter moves the rows
    while leaving two runs bit-identical; this does not. Also counts what
    the compared steps covered: steps with inactive (sentinel) slots,
    requests on reused pages, tokens that fill their last page."""
    import dataclasses

    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    eng = ServeEngine(model32, params32, pcfg, dtype=torch.float32)
    decode = eng._decode
    rows = {}  # rid -> [(position fed, logits row on the host)]
    owner = {}  # page -> the first request seen holding it
    reused = set()  # requests holding a page an earlier request held
    cover = {"steps": 0, "steps_with_inactive_slots": 0,
             "tokens_filling_their_last_page": 0}

    def recording(params, tokens, pages, bt, lengths):
        logits, pages = decode(params, tokens, pages, bt, lengths)
        host = logits[:, 0].float().cpu()
        at = lengths.cpu().tolist()
        active = eng.scheduler.active
        cover["steps"] += 1
        cover["steps_with_inactive_slots"] += len(active) < pcfg.max_slots
        for slot, req in active.items():
            rows.setdefault(req.rid, []).append((at[slot], host[slot]))
            row = eng.alloc.block_table[slot]
            for page in row[row < pcfg.num_pages].tolist():
                if owner.setdefault(page, req.rid) != req.rid:
                    reused.add(req.rid)
            cover["tokens_filling_their_last_page"] += (
                (at[slot] + 1) % pcfg.page_size == 0)
        return logits, pages

    eng._decode = recording
    out = eng.run(prompts, max_new_tokens=new)
    eng._decode = decode
    worst, compared = 0.0, 0
    for rid, seq in sorted(out.items()):
        with torch.no_grad():
            dense = model32.apply(eng.params, {"tokens": torch.from_numpy(
                seq[None]).to(eng.device)})[0][0].float().cpu()
        for pos, row in rows.get(rid, []):
            ok, err = allclose(torch, row, dense[pos], *FP32_TOL)
            check(ok and bool(torch.isfinite(row).all()),
                  f"{cfg.name}: paged decode of request {rid} at position "
                  f"{pos} against the dense logits: max |diff| {err}, "
                  f"rtol/atol {FP32_TOL}")
            worst, compared = max(worst, err), compared + 1
        del dense
    check(compared == len(prompts) * (new - 1),
          f"{cfg.name}: {compared} paged decode rows compared, expected "
          f"{len(prompts) * (new - 1)}")
    cover["requests_on_reused_pages"] = len(reused)
    check(cover["steps_with_inactive_slots"] > 0 and reused
          and cover["tokens_filling_their_last_page"] > 0,
          f"{cfg.name}: the paged witness covered {cover}")
    return {"rows": compared, "max_abs": worst, "rtol_atol": FP32_TOL,
            **cover}


def phase_engine(torch):
    """The continuous-batching ``ServeEngine`` on llama3.2-3b at full size:
    the paged decode against the dense model in fp32, then ENGINE_REQUESTS
    requests through the paged cache in bf16, twice (bit-identical), no
    flash launch (its prefill has no mesh, C7); then resilience_bench's
    serve-degradation section on the card with its gate."""
    import numpy as np

    from repro_torch.benchmarks import resilience_bench
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.kvcache import PagedCacheConfig
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params

    cfg = get_config(SERVE_ARCH)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    params32 = model.init(0, device=dev)
    params = cast_params(params32, torch.bfloat16)
    rng = np.random.default_rng(ENGINE_SEED)
    lo, hi = ENGINE_PROMPT
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(
        np.int32) for n in rng.integers(lo, hi + 1, size=ENGINE_REQUESTS)]
    max_seq = hi + SERVE_NEW
    pcfg = PagedCacheConfig(page_size=ENGINE_PAGE, num_pages=ENGINE_SLOTS * (
        -(-max_seq // ENGINE_PAGE)), max_slots=ENGINE_SLOTS, max_seq=max_seq)
    ops.reset_launch_counts()
    witness = paged_vs_dense(torch, cfg, params32, prompts, pcfg, SERVE_NEW)
    check(ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0),
          f"the fp32 engine launched {ops.launch_counts()}")
    del params32
    torch.cuda.empty_cache()
    runs = [engine_run(torch, model, params, prompts, pcfg) for _ in range(2)]
    first, second = runs
    check(set(first["out"]) == set(range(ENGINE_REQUESTS)),
          f"engine returned requests {sorted(first['out'])}")
    for rid, p in enumerate(prompts):
        got = first["out"][rid]
        check(got.shape == (p.shape[0] + SERVE_NEW,)
              and np.array_equal(got[:p.shape[0]], p)
              and bool(((got >= 0) & (got < cfg.padded_vocab())).all()),
              f"engine request {rid}: {got.shape[0]} tokens for a prompt of "
              f"{p.shape[0]} + {SERVE_NEW}")
        check(np.array_equal(got, second["out"][rid]),
              f"engine request {rid}: two runs differ")
    for r in runs:
        check(r["launches"] == dict.fromkeys(ops.KERNELS, 0),
              f"engine launched {r['launches']}: its prefill has no mesh "
              "and takes no flash kernel (C7)")
    stats = second["stats"]
    steps = sorted(st["decode_s"] for st in stats if st["decode_tokens"])
    prefills = sum(st["prefills"] for st in stats)
    new_tokens = sum(st["decode_tokens"] for st in stats) + prefills
    check(new_tokens == ENGINE_REQUESTS * SERVE_NEW,
          f"engine generated {new_tokens} tokens")
    del params
    torch.cuda.empty_cache()

    sd = resilience_bench.serve_degradation_section(dev)
    bad = resilience_bench.gate_serve_degradation(sd)
    check(not bad, f"serve degradation on the card: {bad}")
    emit({"phase": "engine", "arch": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.dtype, "pool_dtype": "bfloat16",
          "requests": ENGINE_REQUESTS,
          "prompt_tokens": [int(p.shape[0]) for p in prompts],
          "new_tokens": SERVE_NEW, "page_size": pcfg.page_size,
          "num_pages": pcfg.num_pages, "max_slots": pcfg.max_slots,
          "steps": len(stats), "decode_steps": len(steps),
          "prefills": prefills,
          "wall_s": [r["wall_s"] for r in runs],
          "generated_tokens_per_s": new_tokens / second["wall_s"],
          "decode_ms_p50": steps[len(steps) // 2] * 1e3,
          "decode_ms_p99": steps[min(int(len(steps) * 0.99),
                                     len(steps) - 1)] * 1e3,
          "prefill_s_per_request": sum(st.get("prefill_s", 0.0)
                                       for st in stats) / prefills,
          "peak_memory_gb": max(r["peak"] for r in runs) / 1e9,
          "launches": second["launches"], "bitwise_repeat": True,
          "paged_vs_dense_fp32": witness, "serve_degradation": sd})


def param_sums(torch, params) -> list:
    """One int64 sum of each weight's int32 bit patterns, on the card: two
    states with the same bits give the same list."""
    from repro_torch.comm.overlap import tree_flatten
    return torch.stack([p.detach().view(torch.int32).sum(dtype=torch.int64)
                        for p in tree_flatten(params.tree())[0]]).tolist()


def params_sha(params) -> str:
    """sha256 (first 16 hex digits) of every weight's bytes, in tree
    order."""
    from repro_torch.comm.overlap import tree_flatten
    h = hashlib.sha256()
    for p in tree_flatten(params.tree())[0]:
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def train_run(torch, steps: int, sums_at: int) -> dict:
    """TRAIN_ARCH at full size through ``make_train_step`` for ``steps``
    steps: each step's loss, grad norm and seconds, the weights' sums after
    step ``sums_at``, and the peak memory."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.model import build_model
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, 0, device="cuda")
    step = make_train_step(model, RunConfig(
        remat="full", learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP),
        total_steps=TRAIN_STEPS)
    out = {"loss": [], "grad_norm": [], "lr": [], "seconds": []}
    for i in range(steps):
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["loss"].append(loss)
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
        if i + 1 == sums_at:
            out["sums"] = param_sums(torch, state.params)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["params"] = cfg.param_count()
    del state, step
    torch.cuda.empty_cache()
    return out


def train_witness(torch) -> dict:
    """A reduced fp32 llama takes TRAIN_WITNESS_STEPS steps on the card and
    on the CPU from the same state and data: loss, grad norm and weights
    within TRAIN_WITNESS_TOL."""
    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.model import (build_model, state_from_reference,
                                          state_to_reference)
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = reduced(get_config(TRAIN_ARCH), layers=2, d_model=64)
    model = build_model(cfg)
    start = state_to_reference(init_train_state(model, 0, device="cpu"))
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_B, 128))
    run = RunConfig(remat="full", learning_rate=1e-2, warmup_steps=0)
    res = {}
    for where in ("cuda", "cpu"):
        state = state_from_reference(cfg, start, device=where)
        step = make_train_step(model, run)
        metrics = []
        for i in range(TRAIN_WITNESS_STEPS):
            state, m = step(state, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        res[where] = (metrics, tree_flatten(state.params.tree())[0])
    (card, wcard), (cpu, wcpu) = res["cuda"], res["cpu"]
    rt_loss, rt_gnorm, at_w = TRAIN_WITNESS_TOL
    loss_rel = max(abs(a["loss"] / b["loss"] - 1) for a, b in zip(card, cpu))
    gnorm_rel = max(abs(a["grad_norm"] / b["grad_norm"] - 1)
                    for a, b in zip(card, cpu))
    w_abs = max(max_abs(a.cpu(), b) for a, b in zip(wcard, wcpu))
    check(loss_rel <= rt_loss and gnorm_rel <= rt_gnorm and w_abs <= at_w,
          f"train witness, card vs CPU: loss {loss_rel}, grad_norm "
          f"{gnorm_rel} (relative), weights {w_abs} (absolute); limits "
          f"{TRAIN_WITNESS_TOL}")
    return {"config": f"{cfg.name} reduced: {cfg.num_layers} layers, "
                      f"d_model {cfg.d_model}, fp32", "steps":
            TRAIN_WITNESS_STEPS, "loss_rel": loss_rel,
            "grad_norm_rel": gnorm_rel, "weights_max_abs": w_abs,
            "limits": dict(zip(("loss_rtol", "grad_norm_rtol",
                                "weights_atol"), TRAIN_WITNESS_TOL))}


def phase_train(torch, card: str) -> None:
    """Runs :func:`train_phase` in a process of its own (``chip_smoke.py
    --phase-train CARD``) with CUBLAS_WORKSPACE_CONFIG set before CUDA
    starts there: its bit-identical repeat needs cuBLAS's fixed workspace,
    and no other phase runs with it."""
    import os

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         "--phase-train", card], env=env,
                        timeout=TRAIN_TIMEOUT).returncode
    check(rc == 0, f"phase train exited with {rc}")


def train_phase(torch, card: str):
    """llama3.2-3b at full size trained TRAIN_STEPS steps on the card: the
    losses fall, every one finite; a second run's first TRAIN_REPEAT steps
    give the same losses and weights bit for bit (under
    ``torch.use_deterministic_algorithms``); no hand kernel runs (training
    takes the plain attention, as the reference: its flash kernel has no
    VJP). Then the reduced fp32 step on the card against the CPU, and
    ``resilience_bench``'s train-degradation section with its gate."""
    from repro_torch.benchmarks import resilience_bench
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.roofline import H100_BF16_PEAK_FLOPS, model_flops_for

    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    try:
        ops.reset_launch_counts()
        first = train_run(torch, TRAIN_STEPS, TRAIN_REPEAT)
        launches = ops.launch_counts()
        again = train_run(torch, TRAIN_REPEAT, TRAIN_REPEAT)
        witness = train_witness(torch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    losses = first["loss"]
    check(all(math.isfinite(x) for x in losses + first["grad_norm"]),
          f"train: a loss or grad norm is not finite: {losses}, "
          f"{first['grad_norm']}")
    check(losses[-1] < losses[0],
          f"train: the last loss {losses[-1]} is not below the first "
          f"{losses[0]}: {losses}")
    repeat = (again["loss"] == losses[:TRAIN_REPEAT]
              and again["sums"] == first["sums"])
    check(repeat, f"train: two runs differ over {TRAIN_REPEAT} steps: "
                  f"losses {losses[:TRAIN_REPEAT]} vs {again['loss']}, "
                  "weight sums equal: " + str(again["sums"] == first["sums"]))
    check(all(v == 0 for v in launches.values()),
          f"train launched hand kernels: {launches}")
    td = resilience_bench.train_degradation_section("cuda")
    bad = resilience_bench.gate_train_degradation(td)
    check(not bad, f"train-degradation gate: {bad}")
    tokens = TRAIN_B * TRAIN_S
    median_s = statistics.median(first["seconds"][1:])
    # the step's share of the bf16 tensor-core peak: informational, no gate
    mflops = model_flops_for(get_config(TRAIN_ARCH), "train", TRAIN_B,
                             TRAIN_S)
    emit({"phase": "train", "arch": TRAIN_ARCH, "card": card,
          "params": first["params"], "batch": [TRAIN_B, TRAIN_S],
          "dtype": "bfloat16 compute, fp32 weights and moments",
          "remat": "full", "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
          "losses": losses, "grad_norms": first["grad_norm"],
          "lrs": first["lr"], "step_s": first["seconds"],
          "median_step_s_after_first": median_s,
          "tokens_per_s": tokens / median_s,
          "model_flops": mflops,
          "mfu": mflops / median_s / H100_BF16_PEAK_FLOPS,
          "mfu_peak": "bf16 dense tensor-core peak, "
                      f"{H100_BF16_PEAK_FLOPS:.4g} FLOP/s",
          "peak_memory_gb": first["peak"] / 1e9,
          "bitwise_repeat_steps": TRAIN_REPEAT,
          "determinism": "torch.use_deterministic_algorithms(True), "
                         "CUBLAS_WORKSPACE_CONFIG=:4096:8",
          "launches": launches, "card_vs_cpu": witness,
          "train_degradation": {k: td[k] for k in (
              "device", "fault_window", "delay_s", "flagged",
              "forced_checkpoints", "median_before_s", "median_during_s",
              "median_after_s")},
          "seconds": time.perf_counter() - t0})


DP_DIMS = (DP_LAYERS, DP_D, DP_VOCAB, DP_B, DP_S, DP_STEPS)


def dp_cfg(dims):
    from repro_torch.configs import get_config, reduced
    layers, d_model, vocab = dims[:3]
    return reduced(get_config(TRAIN_ARCH), layers=layers, d_model=d_model,
                   vocab=vocab)


def dp_batches(dims):
    from repro_torch.data import DataConfig, SyntheticLMDataset
    vocab, b, s, steps = dims[2:]
    data = SyntheticLMDataset(DataConfig(vocab, b, s))
    return [data.batch(i) for i in range(steps)]


def dp_rank(mesh, device, dims):
    """Runs on every rank of the dp phase: the steps of
    ``make_dp_train_step_explicit`` per schedule of DP_SCHEDULES, each from
    the same initial state, weights on ``device``; ``dims`` is
    :data:`DP_DIMS` (smaller ones make a probe on the CPU)."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm.engine import reset_staged_bytes, staged_bytes
    from repro_torch.comm.overlap import pack_buckets, tree_flatten
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.step import (GRADS_CALLSITE, init_train_state,
                                        make_dp_train_step_explicit)

    if device == "cuda":
        torch.cuda.set_device(0)
    model = build_model(dp_cfg(dims))
    batches = dp_batches(dims)
    out = {}
    for name in DP_SCHEDULES:
        compress = name == "int8_ef"
        state = init_train_state(model, 0, compression_on=compress,
                                 device=device)
        step = make_dp_train_step_explicit(
            model, RunConfig(learning_rate=1e-3, warmup_steps=0,
                             grad_compression="int8_ef" if compress
                             else "none"), mesh,
            schedule_kind="rs_ag" if compress else name)
        rec = {"loss": [], "grad_norm": [], "seconds": []}
        ops.reset_launch_counts()
        reset_staged_bytes()
        for batch in batches:
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            if device == "cuda":
                torch.cuda.synchronize()
            rec["seconds"].append(time.perf_counter() - t0)
            rec["loss"].append(loss)
            rec["grad_norm"].append(float(m["grad_norm"]))
        rec["launches"] = ops.launch_counts().get("ring_add_step", 0)
        rec["staged_bytes"] = staged_bytes()
        rec["sha"] = params_sha(state.params)
        rec["device"] = str(next(state.params.parameters()).device)
        if mesh.rank == 0 and name in DP_WEIGHTS_OF:
            rec["weights"] = [t.detach().float().cpu().numpy() for t in
                              tree_flatten(state.params.tree())[0]]
        if compress:
            rec["error_finite"] = all(bool(torch.isfinite(e).all()) for e in
                                      tree_flatten(state.error)[0])
        leaves = tree_flatten(state.params.tree())[0]
        engine = step.engine
        nbytes = [sum(leaves[i].numel() * 4 for i in b) for b in
                  pack_buckets(leaves, engine.bucket_bytes_for("x"))]
        rec["buckets"] = nbytes
        rec["resolved"] = sorted({engine.schedule_for(
            "allreduce", nbytes=n, axis="x", callsite=GRADS_CALLSITE)
            for n in nbytes})
        out[name] = rec
        del state, step
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_dp(torch):
    """The explicit data-parallel step on DP_RANKS processes sharing the
    card over gloo, per schedule: losses agree across schedules and with
    the one-rank step on the global batch; native and rs_ag leave the
    ranks' weights bit-identical; ring_add_step runs on the schedules that
    reduce through it (rs_ag, int8_ef's transport) and on no other."""
    from repro_torch.comm.engine import schedules_for
    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dp_cfg(DP_DIMS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ranks = spawn_mesh(DP_RANKS, dp_rank, "cuda", DP_DIMS, axes=("x",),
                       timeout=DP_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    model = build_model(cfg)
    state = init_train_state(model, 0, device="cuda")
    step = make_train_step(model, RunConfig(learning_rate=1e-3,
                                            warmup_steps=0))
    one, one_gn = [], []
    for batch in dp_batches(DP_DIMS):
        state, m = step(state, batch)
        one.append(float(m["loss"]))
        one_gn.append(float(m["grad_norm"]))
    one_weights = tree_flatten(state.params.tree())[0]
    # the largest difference from the one-rank step's weights, per schedule
    # whose weights rank 0 handed back
    weight_err = {name: max(
        float((torch.from_numpy(w).to(t.device) - t.float()).abs().max())
        for w, t in zip(ranks[0][name].pop("weights"), one_weights))
        for name in DP_WEIGHTS_OF}
    del state, step, one_weights
    torch.cuda.empty_cache()
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the dp phase")

    def close(a, b, rtol=DP_RTOL):
        return all(abs(x / y - 1) <= rtol for x, y in zip(a, b))

    table = {}
    for name in DP_SCHEDULES:
        recs = [r[name] for r in ranks]
        what = f"dp/{name}"
        check(all(r["device"].startswith("cuda") for r in recs),
              f"{what} ran on {[r['device'] for r in recs]}")
        check(all(math.isfinite(x) for r in recs for x in r["loss"]),
              f"{what}: a loss is not finite")
        resolved = recs[0]["resolved"]
        check(set(resolved) <= set(schedules_for("allreduce")),
              f"{what} resolved {resolved}")
        same_bits = len({r["sha"] for r in recs}) == 1
        if name == "int8_ef":
            check(all(r["error_finite"] for r in recs),
                  f"{what}: the error tree is not finite")
            check(all(close(r["loss"][:1], one[:1]) for r in recs),
                  f"{what}: first loss {recs[0]['loss'][0]} vs the one-rank "
                  f"step's {one[0]}")
            # the first gradient is reduced before any compressed update,
            # through int8 on the wire
            check(all(close(r["grad_norm"][:1], one_gn[:1], DP_INT8_GN_RTOL)
                      for r in recs),
                  f"{what}: first grad norm {recs[0]['grad_norm'][0]} vs "
                  f"the one-rank step's {one_gn[0]} beyond rtol "
                  f"{DP_INT8_GN_RTOL}")
            check(same_bits and len({tuple(r["loss"]) for r in recs}) == 1,
                  f"{what}: the ranks disagree")
        else:
            check(all(close(r["loss"], one) for r in recs),
                  f"{what}: losses {[r['loss'] for r in recs]} vs the "
                  f"one-rank step's {one} beyond rtol {DP_RTOL}")
            check(all(close(r["loss"], x["native"]["loss"])
                      for r, x in zip(recs, ranks)),
                  f"{what}: losses differ from native's beyond rtol "
                  f"{DP_RTOL}")
            check(all(close(r["grad_norm"], one_gn, DP_GN_RTOL)
                      for r in recs),
                  f"{what}: grad norms {[r['grad_norm'] for r in recs]} vs "
                  f"the one-rank step's {one_gn} beyond rtol {DP_GN_RTOL}")
        if name in ("native", "rs_ag"):
            check(same_bits, f"{what}: the ranks' weights differ: "
                             f"{[r['sha'] for r in recs]}")
        if name in DP_WEIGHTS_OF:
            check(weight_err[name] <= DP_WEIGHT_ATOL,
                  f"{what}: weights {weight_err[name]} from the one-rank "
                  f"step's, beyond atol {DP_WEIGHT_ATOL}")
        # rs_ag (and int8_ef's rs_ag transport) accumulate every hop with
        # ring_add_step; native (the library's allreduce) and chain (a
        # plain add, as in the reference's chain) never launch it
        ring = name in ("rs_ag", "int8_ef") or (
            name == "auto" and any(s in ("rs_ag", "ring2d", "int8_ef")
                                   for s in resolved))
        launches = [r["launches"] for r in recs]
        check(all(n > 0 for n in launches) if ring
              else all(n == 0 for n in launches),
              f"{what}: ring_add_step launches per rank {launches}")
        table[name] = {"loss": recs[0]["loss"],
                       "grad_norm": recs[0]["grad_norm"],
                       "step_s": [max(r["seconds"][i] for r in recs)
                                  for i in range(DP_STEPS)],
                       "ring_add_step_per_rank": launches,
                       "staged_bytes_per_rank": recs[0]["staged_bytes"],
                       "ranks_bit_identical": same_bits,
                       "max_abs_weight_diff_vs_one_rank":
                           weight_err.get(name),
                       "resolved": resolved, "buckets": recs[0]["buckets"]}
    emit({"phase": "dp", "arch": f"{TRAIN_ARCH} cut to {DP_LAYERS} layers, "
          f"d_model {DP_D}, vocab {DP_VOCAB}, fp32",
          "params": cfg.param_count(), "ranks": DP_RANKS,
          "global_batch": [DP_B, DP_S], "steps": DP_STEPS,
          "transport": "gloo, staged through host memory; kernels on the "
                       "card",
          "one_rank_loss": one, "one_rank_grad_norm": one_gn,
          "schedules": table, "gates": "ok",
          "seconds": {"ranks": ranks_s, "phase": time.perf_counter() - t0},
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})
    return (sum(ranks[0][n]["launches"] for n in DP_SCHEDULES),
            sum(r[n]["launches"] for r in ranks for n in DP_SCHEDULES))


WHOLE_DIMS = (WHOLE_LAYERS, None, None, WHOLE_B, WHOLE_S, WHOLE_STEPS)


def whole_cfg(dims):
    """TRAIN_ARCH cut to ``dims[0]`` layers at full width in fp32, or, with
    a d_model and vocab in ``dims``, ``reduced()`` to them (a CPU probe)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    layers, d_model, vocab = dims[:3]
    if d_model is None:
        return dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers,
                                   dtype="float32")
    return reduced(get_config(TRAIN_ARCH), layers=layers, d_model=d_model,
                   vocab=vocab)


def whole_batches(vocab: int, b: int, s: int, steps: int):
    from repro_torch.data import DataConfig, SyntheticLMDataset
    data = SyntheticLMDataset(DataConfig(vocab, b, s))
    return [data.batch(i) for i in range(steps)]


def whole_run():
    from repro_torch.configs import RunConfig
    return RunConfig(learning_rate=1e-3, warmup_steps=0)  # remat "full"


def whole_leg(mesh, device, model, batches, mode: str, schedule: str,
              nchunks=1, save_to=None, hand_back: bool = False) -> dict:
    """One leg on this rank: the explicit whole-model step's steps from
    seed 0's state, with this rank's losses, grad norms, seconds (from a
    barrier to the drained card), ring_add_step launches and the count the
    buckets imply, bytes staged by callsite and peak memory. ``save_to``:
    rank 0 writes the whole weights there (``checkpoint.save``);
    ``hand_back``: rank 0 returns them."""
    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.comm.callsites import DP_GRADS
    from repro_torch.comm.engine import (reset_staged_bytes,
                                         staged_bytes_by_callsite)
    from repro_torch.comm.overlap import pack_buckets, tree_flatten
    from repro_torch.kernels import ops
    from repro_torch.train.step import (gather_whole_model_state,
                                        init_train_state,
                                        make_whole_model_train_step_explicit,
                                        shard_whole_model_state,
                                        whole_model_param_specs)

    cuda = device == "cuda"
    state = shard_whole_model_state(init_train_state(model, 0, device=device),
                                    mesh)
    step = make_whole_model_train_step_explicit(
        model, whole_run(), mesh, attn_mode=mode, schedule_kind=schedule,
        nchunks=nchunks)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    reset_staged_bytes()
    rec = {"loss": [], "grad_norm": [], "seconds": []}
    for batch in batches:
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if cuda:
            torch.cuda.synchronize()
        rec["seconds"].append(time.perf_counter() - t0)
        rec["loss"].append(loss)
        rec["grad_norm"].append(float(m["grad_norm"]))
    rec["launches"] = ops.launch_counts().get("ring_add_step", 0)
    rec["staged"] = {str(k): v for k, v in staged_bytes_by_callsite().items()}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else None
    rec["device"] = str(next(state.params.parameters()).device)
    # on the card rs_ag adds each nonempty bucket's hop chunks with
    # ring_add_step 3 times on a ring of 4 (n - 1), and the loss's, and the
    # expert shards' sum of squares where the model has them (on the CPU
    # the wrapper runs its plain version and counts nothing)
    engine = step.engine
    leaves = tree_flatten(state.params.tree())[0]
    specs = tree_flatten(whole_model_param_specs(state.params))[0]
    rep = [t for t, sp in zip(leaves, specs) if sp.replicated]
    buckets = [b for b in pack_buckets(rep, engine.bucket_bytes_for("x"))
               if sum(rep[i].numel() for i in b)]
    hops = mesh.axis("x").size - 1
    per_step = hops * (len(buckets) + 1 + (len(rep) < len(leaves)))
    resolved = sorted({engine.schedule_for(
        "allreduce", nbytes=sum(rep[i].numel() * 4 for i in b), axis="x",
        callsite=DP_GRADS) for b in buckets})
    ring = cuda and any(r in ("rs_ag", "ring2d") for r in resolved)
    rec.update(buckets=len(buckets), dp_grads_resolved=resolved,
               want_launches=per_step * len(batches) if ring else 0)
    if save_to is not None or hand_back:
        whole = gather_whole_model_state(state, mesh)
        if mesh.rank == 0 and save_to is not None:
            ckpt.save(save_to, len(batches), {"params": whole.params})
        if mesh.rank == 0 and hand_back:
            rec["weights"] = [t.detach().cpu().numpy().copy()
                              for t in tree_flatten(whole.params.tree())[0]]
        del whole
        dist.barrier()  # the writer has renamed its directory
    del state, step
    if cuda:
        torch.cuda.empty_cache()
    return rec


def whole_rank(mesh, device, dims, root):
    """Runs on every rank of phase whole: each leg of WHOLE_LEGS on
    ``whole_cfg(dims)`` (the legs of WHOLE_SAVED written under ``root``),
    then the reduced qwen3-moe legs (rank 0 hands their weights back)."""
    import os

    import torch

    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.models.model import build_model

    if device == "cuda":
        # four ranks share the card: segments that grow in place keep each
        # rank's cached but free memory small (set before CUDA starts here)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
    cfg = whole_cfg(dims)
    model = build_model(cfg)
    batches = whole_batches(cfg.vocab_size, *dims[3:])
    out = {}
    for mode, schedule in WHOLE_LEGS:
        save = (os.path.join(root, f"{mode}_{schedule}")
                if (mode, schedule) in WHOLE_SAVED else None)
        out[mode, schedule] = whole_leg(mesh, device, model, batches, mode,
                                        schedule, save_to=save)
    moe = tiny(mesh.axis("x").size, layers=2)
    moe_model = build_model(moe)
    moe_batches = whole_batches(moe.vocab_size, WHOLE_MOE_B, WHOLE_MOE_S,
                                dims[5])
    for mode in ("tp", "sp"):
        for nchunks in WHOLE_MOE_CHUNKS:
            out["moe", mode, nchunks] = whole_leg(
                mesh, device, moe_model, moe_batches, mode, "rs_ag",
                nchunks=nchunks, hand_back=True)
    return out


def one_rank_steps(torch, cfg, batches, device, mus=None):
    """The one-rank ``make_train_step`` on the global batches from seed 0's
    state: losses, grad norms and the final weights (on ``device``); a
    copy of AdamW's first moments after each step appended to ``mus``
    when it is a list."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.train.step import init_train_state, make_train_step

    model = build_model(cfg)
    state = init_train_state(model, 0, device=device)
    step = make_train_step(model, whole_run())
    loss, gn = [], []
    for batch in batches:
        state, m = step(state, batch)
        loss.append(float(m["loss"]))
        gn.append(float(m["grad_norm"]))
        if mus is not None:
            mus.append(tree_map(state.opt["mu"], lambda t: t.clone()))
    return loss, gn, state.params


def run_whole(torch, device, dims, timeout=WHOLE_TIMEOUT) -> dict:
    """Phase whole's legs on WHOLE_RANKS gloo processes, then, after they
    exit, the one-rank comparisons in this process, leg by leg; every gate
    asserted. Returns the record (``dims`` smaller than WHOLE_DIMS and
    ``device="cpu"`` make a probe on the CPU)."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.launch.mesh import spawn_mesh

    rtol_loss, rtol_gn, atol_w = WHOLE_TOL

    def close(a, b, rtol):
        return all(abs(x / y - 1) <= rtol for x, y in zip(a, b))

    def max_diff(xs, ys):
        return max(float((x.to(y.device) - y).abs().max()) if x.numel()
                   else 0.0 for x, y in zip(xs, ys))

    root = tempfile.mkdtemp(prefix="chip_smoke_whole_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_mesh(WHOLE_RANKS, whole_rank, device, dims, root,
                           axes=("x",), timeout=timeout)
        ranks_s = time.perf_counter() - t0
        cfg = whole_cfg(dims)
        one, one_gn, one_params = one_rank_steps(
            torch, cfg, whole_batches(cfg.vocab_size, *dims[3:]), device)
        one_w = tree_flatten(one_params.tree())[0]
        legs, saved = {}, {}
        for mode, schedule in WHOLE_LEGS:
            recs = [r[mode, schedule] for r in ranks]
            what = f"whole/{mode}/{schedule}"
            check(all(r["device"].startswith(device) for r in recs),
                  f"{what} ran on {[r['device'] for r in recs]}")
            check(all(close(r["loss"], one, rtol_loss) for r in recs),
                  f"{what}: losses {[r['loss'] for r in recs]} vs the "
                  f"one-rank step's {one} beyond rtol {rtol_loss}")
            check(all(close(r["grad_norm"], one_gn, rtol_gn) for r in recs),
                  f"{what}: grad norms {[r['grad_norm'] for r in recs]} vs "
                  f"{one_gn} beyond rtol {rtol_gn}")
            launches = [r["launches"] for r in recs]
            check(all(n == r["want_launches"]
                      for n, r in zip(launches, recs)),
                  f"{what}: ring_add_step launches {launches}, want "
                  f"{recs[0]['want_launches']}")
            err = None
            if (mode, schedule) in WHOLE_SAVED:
                # one leg at a time: restore, compare, delete
                d = os.path.join(root, f"{mode}_{schedule}")
                _, got, _ = ckpt.restore(d, {"params": one_params})
                w = tree_flatten(got["params"].tree())[0]
                err = max_diff(w, one_w)
                check(err <= atol_w, f"{what}: weights {err} from the "
                                     f"one-rank step's, beyond {atol_w}")
                saved[mode] = w
                shutil.rmtree(d)
            legs[f"{mode}/{schedule}"] = {
                "loss": recs[0]["loss"], "grad_norm": recs[0]["grad_norm"],
                "step_s": [max(r["seconds"][i] for r in recs)
                           for i in range(len(one))],
                "ring_add_step_per_rank": launches,
                "buckets": recs[0]["buckets"],
                "dp_grads_resolved": recs[0]["dp_grads_resolved"],
                "staged_bytes_per_rank_by_callsite": recs[0]["staged"],
                "peak_gb_per_rank": [r["peak_gb"] for r in recs],
                "max_abs_weight_diff_vs_one_rank": err}
        tp, sp = legs["tp/rs_ag"], legs["sp/rs_ag"]
        tp_sp = max_diff(saved["tp"], saved["sp"])
        check(close(tp["loss"], sp["loss"], rtol_loss)
              and close(tp["grad_norm"], sp["grad_norm"], rtol_gn)
              and tp_sp <= atol_w,
              f"whole: tp and sp disagree (weights {tp_sp})")
        del saved, one_params, one_w
        if device == "cuda":
            torch.cuda.empty_cache()

        moe = tiny(WHOLE_RANKS, layers=2)
        m_one, m_gn, m_params = one_rank_steps(
            torch, moe, whole_batches(moe.vocab_size, WHOLE_MOE_B,
                                      WHOLE_MOE_S, dims[5]), device)
        m_w = tree_flatten(m_params.tree())[0]
        moe_legs = {}
        for mode in ("tp", "sp"):
            for nchunks in WHOLE_MOE_CHUNKS:
                recs = [r["moe", mode, nchunks] for r in ranks]
                what = f"whole/moe/{mode}/nchunks={nchunks}"
                err = max_diff([torch.from_numpy(w)
                                for w in recs[0]["weights"]], m_w)
                launches = [r["launches"] for r in recs]
                check(all(close(r["loss"], m_one, rtol_loss)
                          and close(r["grad_norm"], m_gn, rtol_gn)
                          for r in recs) and err <= atol_w,
                      f"{what}: losses {recs[0]['loss']} vs {m_one}, grad "
                      f"norms {recs[0]['grad_norm']} vs {m_gn}, weights "
                      f"{err}")
                check(all(n == r["want_launches"] and (n > 0 or
                                                       device == "cpu")
                          for n, r in zip(launches, recs)),
                      f"{what}: ring_add_step launches {launches}, want "
                      f"{recs[0]['want_launches']}")
                moe_legs[f"{mode}/nchunks={nchunks}"] = {
                    "loss": recs[0]["loss"],
                    "grad_norm": recs[0]["grad_norm"],
                    "step_s": [max(r["seconds"][i] for r in recs)
                               for i in range(len(m_one))],
                    "ring_add_step_per_rank": launches,
                    "staged_bytes_per_rank_by_callsite": recs[0]["staged"],
                    "max_abs_weight_diff_vs_one_rank": err}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"legs": legs, "one_rank_loss": one, "one_rank_grad_norm": one_gn,
            "tp_vs_sp_max_abs_weight_diff": tp_sp, "moe_legs": moe_legs,
            "moe_one_rank_loss": m_one, "params": cfg.param_count(),
            "seconds_ranks": ranks_s,
            "launches_rank0": sum(r["launches"] for r in ranks[0].values()),
            "launches_all": sum(r["launches"] for x in ranks
                                for r in x.values())}


def phase_whole(torch, card: str):
    """The explicit whole-model step on WHOLE_RANKS processes sharing the
    card over gloo (the legs of WHOLE_LEGS at full width, the reduced
    qwen3-moe legs), held against the one-rank step on the global batch;
    ring_add_step launched 3 times per nonempty bucket plus 3 per step on
    rs_ag and never on native; then failover_bench's rank-loss section
    with its gate."""
    from repro_torch.benchmarks import failover_bench
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = run_whole(torch, "cuda", WHOLE_DIMS)
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the whole phase")
    t1 = time.perf_counter()
    rl = failover_bench.rank_loss_section("cuda", quick=True)
    bad = failover_bench.gate_rank_loss(rl)
    check(not bad, f"rank-loss gate: {bad}")
    emit({"phase": "whole", "arch": f"{TRAIN_ARCH} at full width cut to "
          f"{WHOLE_LAYERS} layers, fp32 weights, moments and compute",
          "card": card, "params": rec["params"], "ranks": WHOLE_RANKS,
          "global_batch": [WHOLE_B, WHOLE_S], "steps": WHOLE_STEPS,
          "card_free_gb_at_start": free_gb,
          "remat": "full", "tolerances": {
              "loss_rtol": WHOLE_TOL[0], "grad_norm_rtol": WHOLE_TOL[1],
              "weights_atol": WHOLE_TOL[2]},
          "transport": "gloo, staged through host memory; kernels on the "
                       "card",
          "staged_bytes_note": "per rank, by callsite; under remat full "
                               "the forward exchanges of every layer run "
                               "again in the backward and count again; "
                               "'None' is the loss's (and the MoE expert "
                               "shards' sum of squares') allreduce",
          "one_rank_loss": rec["one_rank_loss"],
          "one_rank_grad_norm": rec["one_rank_grad_norm"],
          "legs": rec["legs"],
          "tp_vs_sp_max_abs_weight_diff": rec["tp_vs_sp_max_abs_weight_diff"],
          "moe": {"config": "qwen3-moe-235b-a22b tiny(4, layers=2), fp32, "
                            f"{WHOLE_MOE_B} x {WHOLE_MOE_S} tokens, rs_ag",
                  "one_rank_loss": rec["moe_one_rank_loss"],
                  "legs": rec["moe_legs"]},
          "rank_loss": {k: rl[k] for k in (
              "steps", "fail_at", "lost_rank", "recovery", "sat_out",
              "resumed_losses", "control_losses", "loss_bitwise",
              "device")},
          "gates": "ok",
          "seconds": {"ranks": rec["seconds_ranks"],
                      "whole": t1 - t0, "rank_loss": time.perf_counter() - t1},
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})
    return rec["launches_rank0"], rec["launches_all"]


def gspmd_train_leg(mesh, device, model, batches, fsdp: bool,
                    save_to, moments: bool = False) -> dict:
    """One train leg on this rank: ``make_train_step`` on the GSPMD
    placement from seed 0's whole state cut by ``shard_state`` (ZeRO-1
    on), with this rank's losses, grad norms, seconds (from a barrier to
    the drained card), launches, bytes staged by source and peak memory;
    then the whole weights, gathered (``gather_params``), written by rank 0
    to ``save_to``, with ``moments`` also AdamW's first moments
    (``gather_state``)."""
    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.train.step import (gather_params, gather_state,
                                        init_train_state, make_train_step,
                                        shard_state)

    cuda = device == "cuda"
    state = shard_state(init_train_state(model, 0, device=device), mesh,
                        zero1=True, fsdp=fsdp)
    step = make_train_step(model, whole_run(), mesh, zero1=True, fsdp=fsdp)
    leg_start(torch, device)
    rec = {"loss": [], "grad_norm": [], "seconds": []}
    for batch in batches:
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        if cuda:
            torch.cuda.synchronize()
        rec["seconds"].append(time.perf_counter() - t0)
        rec["loss"].append(loss)
        rec["grad_norm"].append(float(m["grad_norm"]))
    leg_end(torch, device, rec)
    rec["device"] = str(next(state.params.parameters()).device)
    if moments:
        whole = gather_state(state, model, mesh, fsdp=fsdp)
        trees = {"params": whole.params, "mu": whole.opt["mu"]}
    else:
        whole = gather_params(state.params, model, mesh, fsdp=fsdp)
        trees = {"params": whole}
    if mesh.rank == 0:
        ckpt.save(save_to, len(batches), trees)
    del whole, trees, state, step
    dist.barrier()  # the writer has renamed its directory
    if cuda:
        torch.cuda.empty_cache()
    return rec


def seeded_tokens(cfg, rows: int, seq: int, device):
    """``rows`` x ``seq`` prompt tokens drawn from seed 1 on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen,
                         device=device, dtype=torch.int32)


def prefill_run(model, params, mesh, batch, rows=None, decode=None,
                aux=None) -> dict:
    """The prefill of ``batch`` (its tokens this rank's rows, with the
    frames or patches a family takes) on ``mesh`` (None: one rank through
    the plain attention; a one-rank mesh: through flash), then one decode
    step for each column of ``decode``, its tokens fed in. ``rows`` is the
    global batch a mesh's cache is cut from (None: a whole cache of the
    batch's rows). Returns the logits (with steps: the prefill's last
    position's and each step's), the seconds of the prefill and of each
    step, and the cache's shapes per layer; with a list ``aux``, each MoE
    layer's (moe_dropped, moe_frac_tokens) appended to it by a spy on
    ``apply_moe``."""
    import torch

    from repro_torch.models import moe
    from repro_torch.train.serve import make_decode_step, make_prefill_step

    tokens = batch["tokens"]
    steps = 0 if decode is None else decode.shape[1]
    cache = model.init_cache(rows or len(tokens), tokens.shape[1] + steps,
                             params.embed.dtype, device=tokens.device,
                             mesh=mesh if rows else None)
    shapes = [{k: list(v.shape) for k, v in lay.items()}
              for lay in cache["layers"]]
    orig = moe.apply_moe

    def spy(p, cfg, x, aux_in=None, shard=None):
        got = {}
        out = orig(p, cfg, x, aux=got, shard=shard)
        aux.append((float(got["moe_dropped"]), got["moe_frac_tokens"].cpu()))
        return out

    def lap(t0):
        if tokens.is_cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)

    if aux is not None:
        moe.apply_moe = spy
    secs = []
    try:
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(model, mesh)(params, batch, cache)
        lap(t0)
        if steps:
            outs, step = [logits[:, -1:]], make_decode_step(model, mesh)
            for i in range(steps):
                t0 = time.perf_counter()
                logits, cache = step(params, decode[:, i:i + 1], cache, {})
                lap(t0)
                outs.append(logits)
            logits = torch.cat(outs, 1)
    finally:
        moe.apply_moe = orig
    return {"logits": logits, "seconds": secs, "cache_shapes": shapes,
            "aux": aux}


def gspmd_prefill(mesh, device, model, batch, rows: int, *, params=None,
                  want=None, decode=None, aux=False, keep=False) -> dict:
    """``batch`` (this rank's rows of a global batch of ``rows``)
    prefilled on ``mesh`` with this rank's heads, KV heads and experts
    (flash on the card), then fed ``decode``'s tokens a step each, against
    the one-rank run of the same rows through the plain attention, as
    phase serve holds flash to it. ``want`` is that one-rank run
    (:func:`prefill_run`, ``mesh=None``) where the caller made it, and
    ``params`` then this rank's part of the weights; otherwise it is made
    here from the whole ``params`` (seed 0's when None), which are then
    cut. The record holds the max |d| and the share of the bf16 flash limit
    (:func:`flash_limit_share`), the seconds, the cache's shapes and what
    :func:`leg_end` reads; with ``aux`` each MoE layer's drops beside the
    one-rank run's; with ``keep`` the logits and this rank's weights."""
    import torch

    if want is None:
        if params is None:
            params = model.init(0, device=device)
        want = prefill_run(model, params, None, batch, decode=decode,
                           aux=[] if aux else None)
        params = cut_params(params, mesh)
    leg_start(torch, device)
    got = prefill_run(model, params, mesh, batch, rows, decode,
                      [] if aux else None)
    logits = got["logits"]
    rec = leg_end(torch, device, {"seconds": got["seconds"][0],
                                  "finite": bool(torch.isfinite(logits).all()),
                                  "shape": list(logits.shape),
                                  "cache_shapes": got["cache_shapes"]})
    rec["vs_one_rank"] = flash_limit_share(logits, want["logits"])
    rec["max_abs_vs_one_rank"] = rec["vs_one_rank"]["max_abs"]
    if decode is not None:
        steps = sorted(got["seconds"][1:])
        rec["decode_ms_p50"] = steps[len(steps) // 2] * 1e3
    if aux:
        rec["dropped"] = [a[0] for a in got["aux"]]
        rec["dropped_one_rank"] = [a[0] for a in want["aux"]]
        rec["frac_equal"] = len(got["aux"]) == len(want["aux"]) and all(
            torch.equal(a[1], w[1]) for a, w in zip(got["aux"], want["aux"]))
    if keep:
        rec["logits"], rec["params"] = logits, params
    else:
        del logits, params
        if device == "cuda":
            torch.cuda.empty_cache()
    return rec


def gspmd_serve(mesh, device, model, rows: int, seq: int, new: int,
                ring=None, one_rank_flash: bool = True) -> dict:
    """bf16 ``generate`` of ``rows`` x ``seq`` prompts and ``new`` tokens
    on ``mesh`` twice, then its prefill and decode steps timed apart, each
    with what :func:`leg_end` reads; the prefill's logits against the
    one-rank bf16 prefill of this rank's rows through the plain attention
    (and, to read beside them, the one-rank prefill through flash against
    it, unless ``one_rank_flash`` is False). With a ``ring`` one rank at a
    time draws the whole weights and runs the one-rank prefills
    (:func:`in_turn`)."""
    import dataclasses

    import torch

    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params
    from repro_torch.train.serve import (generate, make_decode_step,
                                         make_prefill_step)

    cuda = device == "cuda"
    model = build_model(dataclasses.replace(model.cfg, dtype="bfloat16"))
    cfg = model.cfg
    prompts = seeded_tokens(cfg, rows, seq, device)
    mine = prompts[rows_of(mesh, rows)]

    def draw():
        params = cast_params(model.init(0, device=device), torch.bfloat16)

        def one_rank(m):
            return prefill_run(model, params, m, {"tokens": mine})[
                "logits"].cpu()
        return (params, one_rank(None), one_rank(single_rank_mesh(("x",)))
                if one_rank_flash else None)

    params, plain, one_flash = draw() if ring is None else in_turn(ring, draw)
    leg_start(torch, device)
    out = generate(model, params, prompts, max_new_tokens=new, mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    rec = {"generate": leg_end(torch, device, {
        "shape": list(out.shape),
        "prompts_kept": bool(torch.equal(out[:, :seq], mine)),
        "in_vocab": bool(((out >= 0) & (out < cfg.padded_vocab())).all())})}
    again = generate(model, params, prompts, max_new_tokens=new, mesh=mesh)
    rec["generate"]["bitwise_repeat"] = bool(torch.equal(again, out))
    del again
    local = cut_params(params, mesh)
    del params

    cache = model.init_cache(rows, seq + new, torch.bfloat16, device=device,
                             mesh=mesh)
    decode = make_decode_step(model, mesh)
    leg_start(torch, device)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model, mesh)(local, {"tokens": mine},
                                                   cache)
    if cuda:
        torch.cuda.synchronize()
    rec["prefill"] = pre = leg_end(torch, device,
                                   {"seconds": time.perf_counter() - t0})
    pre["vs_one_rank_plain"] = flash_limit_share(logits, plain)
    if one_rank_flash:
        pre["one_rank_flash_vs_plain"] = flash_limit_share(one_flash, plain)
    tok = torch.argmax(logits[:, -1], dim=-1).to(mine.dtype)[:, None]
    del logits, plain, one_flash
    toks, steps = [tok], []
    leg_start(torch, device)
    for _ in range(new - 1):
        t0 = time.perf_counter()
        logits, cache = decode(local, tok, cache, {})
        if cuda:
            torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        tok = torch.argmax(logits[:, -1], dim=-1).to(mine.dtype)[:, None]
        toks.append(tok)
    steps.sort()
    rec["decode"] = leg_end(torch, device, {
        "steps_match_generate": bool(torch.equal(torch.cat(toks, 1),
                                                 out[:, seq:])),
        "ms_p50": steps[len(steps) // 2] * 1e3})
    del cache, local, out
    if cuda:
        torch.cuda.empty_cache()
    return rec


def hold_serve(what, srv, layers: int, min_within=None):
    """:func:`gspmd_serve`'s gates over every rank's record: ``layers``
    flash launches on ``wgmma_bf16`` in the generate and in the timed
    prefill, none in decode and nothing else; two bit-identical runs, the
    decode steps the generate's tokens, the prompts kept and the vocab
    held; the prefill's logits within the bf16 flash limit of the one-rank
    plain prefill's, or, with ``min_within``, at least that share of its
    positions wholly within it."""
    from repro_torch.kernels import ops

    none = dict.fromkeys(ops.KERNELS, 0)
    want = {**none, "flash_attention": layers}
    routes = {"wgmma_bf16": layers} if layers else {}
    for r in srv:
        g, pre, dec = r["generate"], r["prefill"], r["decode"]
        check(g["launches"] == want and g["flash_routes"] == routes
              and pre["launches"] == want and pre["flash_routes"] == routes,
              f"{what}: generate launched {g['launches']} on "
              f"{g['flash_routes']}, prefill {pre['launches']} on "
              f"{pre['flash_routes']}; want {layers} flash launches on "
              "wgmma_bf16 each and nothing else")
        check(dec["launches"] == none,
              f"{what}: {dec['launches']} launched in decode")
        check(g["bitwise_repeat"] and dec["steps_match_generate"],
              f"{what}: two greedy runs (or the timed steps) differ")
        check(g["prompts_kept"] and g["in_vocab"],
              f"{what}: generate changed the prompts or left the vocab")
        v = pre["vs_one_rank_plain"]
        if min_within is None:
            check(v["limit_share"] <= 1.0,
                  f"{what}: bf16 prefill logits vs the one-rank prefill's "
                  f"through the plain attention {v}, beyond atol "
                  f"{FLASH_ATOL['bfloat16']} + rtol {FLASH_RTOL} |want|")
        else:
            check(v["within_share"] >= min_within,
                  f"{what}: {v['within_share']} of the bf16 prefill's "
                  "positions within atol "
                  f"{FLASH_ATOL['bfloat16']} + rtol {FLASH_RTOL} |want| of "
                  f"the one-rank plain prefill's, want {min_within} ({v})")


def flash_limit_share(got, want) -> dict:
    """The max |got - want| of two logit tensors, a row at a time on
    ``got``'s device, the largest share of the bf16 flash limit
    FLASH_ATOL + FLASH_RTOL |want| that any element uses (> 1: beyond),
    and the share of positions (rows x tokens) whose logits are all
    within it."""
    err, share, within, n = 0.0, 0.0, 0, 0
    for g, w in zip(got, want):
        w = w.to(g.device).float()
        d = (g.float() - w).abs()
        err = max(err, float(d.max()))
        r = d / (FLASH_ATOL["bfloat16"] + FLASH_RTOL * w.abs())
        share = max(share, float(r.max()))
        pos = r.amax(-1)
        within, n = within + int((pos <= 1).sum()), n + pos.numel()
    return {"max_abs": err, "limit_share": share, "within_share": within / n}


def gspmd_ring_leg(mesh, device, moe, batches) -> dict:
    """The reduced qwen3-moe GSPMD step on the ring: whole weights on every
    rank, moments over ``x``; rank 0 hands the weights back."""
    import torch

    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.models.model import build_model
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)

    model = build_model(moe)
    state = shard_state(init_train_state(model, 0, device=device), mesh)
    step = make_train_step(model, whole_run(), mesh)
    rec = {"loss": [], "grad_norm": []}
    for batch in batches:
        state, m = step(state, batch)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    if mesh.rank == 0:
        rec["weights"] = [t.detach().cpu().numpy().copy()
                          for t in tree_flatten(state.params.tree())[0]]
    del state, step
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def gspmd_rank(mesh, device, dims, root):
    """Runs on every rank of phase gspmd: the train legs of GSPMD_LEGS on
    the 2x2 mesh (weights written under ``root``), the fp32 prefill and
    the bf16 generate there, then the ring legs. ``dims`` is
    :data:`GSPMD_DIMS` (smaller ones make a probe on the CPU)."""
    import os

    import torch

    from repro_torch.benchmarks import lm_step_bench
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model

    if device == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
    grid = make_mesh(*GSPMD_MESH)
    ring = make_mesh((mesh.axis("x").size,), ("x",))
    cfg = whole_cfg(dims)
    model = build_model(cfg)
    batches = whole_batches(cfg.vocab_size, *dims[3:6])
    out = {"train": {name: gspmd_train_leg(grid, device, model, batches,
                                           fsdp, os.path.join(root, name))
                     for name, fsdp in GSPMD_LEGS}}
    out["prefill"] = gspmd_prefill(
        grid, device, model, {"tokens": seeded_tokens(
            cfg, dims[6], dims[8], device)[rows_of(grid, dims[6])]}, dims[6])
    out["serve"] = gspmd_serve(grid, device, model, dims[7], dims[8],
                               dims[9])
    moe = tiny(ring.axis("x").size, layers=2)
    out["moe"] = gspmd_ring_leg(ring, device, moe, whole_batches(
        moe.vocab_size, WHOLE_MOE_B, WHOLE_MOE_S, dims[5]))
    out["moe_explicit"] = lm_step_bench.moe_explicit_rank(ring, "auto", 16,
                                                          device)
    return out


def run_gspmd(torch, device, dims, timeout=GSPMD_TIMEOUT) -> dict:
    """Phase gspmd's legs on GSPMD_RANKS gloo processes, then, after they
    exit, the one-rank comparisons in this process; every gate asserted.
    Returns the record (``dims`` smaller than GSPMD_DIMS and
    ``device="cpu"`` make a probe on the CPU)."""
    import shutil
    import tempfile

    from repro_torch.benchmarks import lm_step_bench
    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh

    rtol_loss, rtol_gn, atol_w = WHOLE_TOL
    # one flash launch per layer per prefill on the card; on the CPU the
    # wrapper takes its plain version and counts nothing
    layers = dims[0] if device == "cuda" else 0
    close = close_rel

    root = tempfile.mkdtemp(prefix="chip_smoke_gspmd_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_mesh(GSPMD_RANKS, gspmd_rank, device, dims, root,
                           axes=("x",), timeout=timeout)
        ranks_s = time.perf_counter() - t0
        cfg = whole_cfg(dims)
        legs = hold_train_legs(
            torch, "gspmd", {name: [r["train"][name] for r in ranks]
                             for name, _ in GSPMD_LEGS},
            cfg, whole_batches(cfg.vocab_size, *dims[3:6]), device, root)
        first = legs[GSPMD_LEGS[0][0]]
        one, one_gn = first["one_rank_loss"], first["one_rank_grad_norm"]
        none = dict.fromkeys(ops.KERNELS, 0)

        pre = [r["prefill"] for r in ranks]
        route = "simt_f32"
        check(all(p["finite"] for p in pre), "gspmd: fp32 prefill logits "
                                             "not finite")
        err32 = [p["max_abs_vs_one_rank"] for p in pre]
        check(all(e <= FP32_PREFILL_ATOL for e in err32),
              f"gspmd: fp32 prefill {err32} from the one-rank prefill's "
              f"through the plain attention, beyond {FP32_PREFILL_ATOL}")
        want_flash = {**none, "flash_attention": layers}
        check(all(p["launches"] == want_flash for p in pre) and all(
            p["flash_routes"] == ({route: layers} if layers else {})
            for p in pre),
              f"gspmd: fp32 prefill launches {[p['launches'] for p in pre]}"
              f" routes {[p['flash_routes'] for p in pre]}")

        srv = [r["serve"] for r in ranks]
        hold_serve("gspmd", srv, layers)
        # the two ranks of one data index hold the same rows
        for a, b in ((0, 1), (2, 3)):
            check(srv[a]["generate"]["shape"] == srv[b]["generate"]["shape"],
                  "gspmd: the model axis disagrees on the output")

        moe = tiny(GSPMD_RANKS, layers=2)
        m_one, m_gn, m_params = one_rank_steps(
            torch, moe, whole_batches(moe.vocab_size, WHOLE_MOE_B,
                                      WHOLE_MOE_S, dims[5]), device)
        m_err = max_diff([torch.from_numpy(w) for w in
                          ranks[0]["moe"]["weights"]],
                         tree_flatten(m_params.tree())[0])
        check(all(close(r["moe"]["loss"], m_one, rtol_loss)
                  and close(r["moe"]["grad_norm"], m_gn, rtol_gn)
                  for r in ranks) and m_err <= atol_w,
              f"gspmd/moe ring: losses {ranks[0]['moe']['loss']} vs {m_one}, "
              f"grad norms {ranks[0]['moe']['grad_norm']} vs {m_gn}, "
              f"weights {m_err}")
        mx = lm_step_bench.moe_explicit_record(
            [r["moe_explicit"] for r in ranks], "auto", 16, device)
        bad = lm_step_bench.gate_resolved(mx)
        check(mx["within_tolerance"] and not bad and mx["ranks_agree"],
              f"gspmd/moe_explicit: max|d| {mx['max_abs_err_vs_gspmd']}, "
              f"unregistered {bad}, ranks agree {mx['ranks_agree']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"legs": legs, "one_rank_loss": one, "one_rank_grad_norm": one_gn,
            "params": cfg.param_count(), "seconds_ranks": ranks_s,
            "prefill": {"batch": [dims[6], dims[8]], "flash_route": route,
                        "max_abs_vs_one_rank_plain": max(err32),
                        "atol": FP32_PREFILL_ATOL},
            "serve": {"batch": [dims[7], dims[8]], "new_tokens": dims[9],
                      "flash_launches_per_rank_per_prefill": [
                          r["prefill"]["launches"]["flash_attention"]
                          for r in srv],
                      "prefill_vs_one_rank_plain": [
                          r["prefill"]["vs_one_rank_plain"] for r in srv],
                      "one_rank_flash_vs_plain": [
                          r["prefill"]["one_rank_flash_vs_plain"]
                          for r in srv],
                      "prefill_tol": {"atol": FLASH_ATOL["bfloat16"],
                                      "rtol": FLASH_RTOL},
                      "prefill_s": max(r["prefill"]["seconds"] for r in srv),
                      "decode_ms_p50": max(r["decode"]["ms_p50"]
                                           for r in srv),
                      "peak_gb_per_rank": [r["generate"]["peak_gb"]
                                           for r in srv],
                      "bitwise_repeat": True},
            "moe_ring": {"config": "qwen3-moe-235b-a22b tiny(4, layers=2), "
                                   f"fp32, {WHOLE_MOE_B} x {WHOLE_MOE_S} "
                                   "tokens, ring ('x',) of 4",
                         "loss": ranks[0]["moe"]["loss"],
                         "one_rank_loss": m_one,
                         "max_abs_weight_diff_vs_one_rank": m_err},
            "moe_explicit": {k: mx[k] for k in (
                "max_abs_err_vs_gspmd", "within_tolerance", "t_gspmd_s",
                "t_explicit_s", "t_dp_step_s", "resolved", "nchunks")}}


def phase_gspmd(torch, card: str):
    """The GSPMD placement on GSPMD_RANKS processes sharing the card over
    gloo (2x2 train legs, fp32 prefill, bf16 generate, the ring legs), held
    against the one-rank step and the one-rank plain prefill; returns
    each rank's flash launches in its timed bf16 prefill."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = run_gspmd(torch, "cuda", GSPMD_DIMS)
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the gspmd phase")
    emit({"phase": "gspmd", "arch": f"{TRAIN_ARCH} at full width cut to "
          f"{GSPMD_LAYERS} layers", "card": card, "params": rec["params"],
          "ranks": GSPMD_RANKS, "mesh": {"shape": GSPMD_MESH[0],
                                         "names": GSPMD_MESH[1]},
          "train": {"global_batch": [WHOLE_B, WHOLE_S], "steps": WHOLE_STEPS,
                    "dtype": "float32", "remat": "full",
                    "one_rank_loss": rec["one_rank_loss"],
                    "one_rank_grad_norm": rec["one_rank_grad_norm"],
                    "tolerances": {"loss_rtol": WHOLE_TOL[0],
                                   "grad_norm_rtol": WHOLE_TOL[1],
                                   "weights_atol": WHOLE_TOL[2]},
                    "legs": rec["legs"]},
          "prefill_fp32": rec["prefill"], "serve_bf16": rec["serve"],
          "moe_ring": rec["moe_ring"], "moe_explicit": rec["moe_explicit"],
          "card_free_gb_at_start": free_gb,
          "transport": "gloo, staged through host memory; kernels on the "
                       "card",
          "staged_bytes_note": "per rank, by source (partition.SOURCES); "
                               "under remat full the forward's tp "
                               "reductions run again in the backward",
          "gates": "ok",
          "seconds": {"ranks": rec["seconds_ranks"],
                      "phase": time.perf_counter() - t0},
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})
    return rec["serve"]["flash_launches_per_rank_per_prefill"]


def fam_cfgs(dims) -> dict:
    """Phase gspmd_families' configs: MOE_ARCH and VLM_ARCH at full width
    cut in depth, SSM_ARCH and WHISPER_ARCH at full size, or, with a
    ``dims['width']``, ``reduced()`` to it (a probe on the CPU); the
    reduced MoE and hybrid that train (FAM_TRAIN_NOTE)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny

    def cut(arch, layers, dtype):
        base = get_config(arch)
        if dims["width"] is None:
            cfg = dataclasses.replace(base,
                                      num_layers=layers or base.num_layers)
        else:
            cfg = reduced(base, layers=layers or 2, d_model=dims["width"])
        return dataclasses.replace(cfg, dtype=dtype)

    return {"moe": cut(MOE_ARCH, dims["moe_layers"], "float32"),
            "ssm": cut(SSM_ARCH, None, "float32"),
            "vlm": cut(VLM_ARCH, dims["vlm_layers"], "bfloat16"),
            "whisper": cut(WHISPER_ARCH, None, "float32"),
            "moe_train": tiny(FAM_RANKS, layers=2),
            "hybrid_train": reduced(get_config(HYBRID_ARCH), layers=4)}


def fam_train_legs(cfgs, dims) -> dict:
    """name -> (config, rows, tokens) of the phase's GSPMD train legs."""
    return {"qwen3-moe": (cfgs["moe_train"], WHOLE_MOE_B, WHOLE_MOE_S),
            "jamba": (cfgs["hybrid_train"], WHOLE_MOE_B, WHOLE_MOE_S),
            "mamba2": (cfgs["ssm"], dims["train_b"], dims["seq"]),
            "whisper": (cfgs["whisper"], dims["whisper_b"],
                        dims["whisper_s"])}


def fam_batches(cfg, b: int, s: int, steps: int):
    """The synthetic token batches, with frames drawn from a seed for the
    encoder-decoder."""
    import torch

    batches = whole_batches(cfg.vocab_size, b, s, steps)
    if cfg.is_encoder_decoder:
        gen = torch.Generator().manual_seed(FAM_FRAMES_SEED)
        for batch in batches:
            batch["frames"] = torch.randn((b, cfg.audio_ctx, cfg.d_model),
                                          generator=gen)
    return batches


def in_turn(ring, fn):
    """``fn()`` on every rank of the ring in rank order, the others waiting
    at a barrier (each turn may hold a whole model on the card); this
    rank's result."""
    import torch
    import torch.distributed as dist

    ax = ring.axis("x")
    out = None
    for turn in range(ax.size):
        if turn == ax.index:
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def rows_of(mesh, n: int) -> slice:
    """This rank's ``batch_specs`` rows of a global batch of ``n``."""
    from repro_torch import sharding as sh
    idx, k = sh.block_of(mesh, sh.rules_for(mesh).dp_spec)
    return slice(idx * n // k, (idx + 1) * n // k)


def cut_params(params, mesh):
    """A copy of this rank's part of the whole weights under
    ``param_specs`` (the whole weights can then be freed)."""
    from repro_torch import sharding as sh
    return type(params)(params.cfg, sh.cut(params.tree(), sh.param_specs(
        params, sh.rules_for(mesh), mesh), mesh))


def rows_max_abs(got, want) -> float:
    """max |got - want|, a row at a time on ``got``'s device (``want`` may
    be on the host)."""
    return max(float((g.float() - w.to(g.device).float()).abs().max())
               for g, w in zip(got, want))


def leg_start(torch, device):
    """Zero the launch counts, the staged bytes and the peak memory."""
    from repro_torch.comm.engine import reset_staged_bytes
    from repro_torch.kernels import ops
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    reset_staged_bytes()


def leg_end(torch, device, rec: dict) -> dict:
    """``rec`` with this leg's launches, flash routes, bytes staged by
    source and peak memory."""
    from repro_torch.comm.engine import staged_bytes_by_callsite
    from repro_torch.kernels import attention as kfa
    from repro_torch.kernels import ops
    rec["launches"] = ops.launch_counts()
    rec["flash_routes"] = {k: v for k, v in
                           kfa.flash_attention.launches_by_route.items() if v}
    rec["staged"] = {str(k): v for k, v in staged_bytes_by_callsite().items()}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
        if device == "cuda" else None
    return rec


def fam_pages(torch, cfg, slots: int, seq: int, device):
    """A page pool drawn from a seed (every slot ``ceil((seq + 1) / page)``
    pages of ENGINE_PAGE, its own), the block table, lengths in
    [seq / 2, seq) and one token a slot."""
    per = -(-(seq + 1) // ENGINE_PAGE)
    gen = torch.Generator(device=device).manual_seed(FAM_PAGES_SEED)
    shape = (slots * per, ENGINE_PAGE, cfg.num_kv_heads, cfg.head_dim)
    pool = {"layers": [{k: torch.randn(shape, generator=gen, device=device)
                        for k in ("k_pages", "v_pages")}
                       for _ in range(cfg.num_layers)]}
    table = torch.arange(slots * per, dtype=torch.int32,
                         device=device).reshape(slots, per)
    lengths = torch.randint(seq // 2, seq, (slots,), generator=gen,
                            device=device, dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (slots, 1), generator=gen,
                           device=device, dtype=torch.int32)
    return pool, table, lengths, tokens


def paged_mine(pool, table, rows, heads):
    """This rank's view of a pool: the pages its rows own, its KV heads."""
    own = table[rows].flatten().long()
    start, n = heads
    return [[v[own][:, :, start:start + n] for v in lay.values()]
            for lay in pool["layers"]]


def fam_moe(grid, ring, device, cfg, dims) -> dict:
    """MOE_ARCH on the 2x2 mesh: :func:`gspmd_prefill` in fp32 with every
    MoE layer's drops; the fp32 paged decode step against the one-rank one
    from identical pages; :func:`gspmd_serve` in bf16 (held by the share
    of positions within the bf16 limit: bf16 router logits keep 8 bits,
    so any rounding of the hidden state, the flash kernel's own too, flips
    near-tied top-k choices and moves those tokens' logits by O(1); the
    fp32 prefill holds the function). One rank at a time draws the whole
    weights."""
    import torch

    from repro_torch.models.kvcache import pool_heads
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import decode_rows, make_paged_decode_step

    model = build_model(cfg)
    seq, b32 = dims["seq"], dims["prefill_b"]
    batch = {"tokens": seeded_tokens(cfg, b32, seq, device)[
        rows_of(grid, b32)]}
    slots = dims["paged_slots"]
    pool, table, lengths, ptok = fam_pages(torch, cfg, slots, seq, device)
    prow, heads = decode_rows(grid, slots), pool_heads(cfg, grid)

    def draw_fp32():
        params = model.init(0, device=device)
        want = prefill_run(model, params, None, batch, aux=[])
        want["logits"] = want["logits"].cpu()
        whole = {"layers": [{k: v.clone() for k, v in lay.items()}
                            for lay in pool["layers"]]}
        plog, whole = make_paged_decode_step(model, None)(
            params, ptok, whole, table, lengths)
        paged = {"logits": plog[prow].cpu(),
                 "pages": [[v.cpu() for v in lay] for lay in
                           paged_mine(whole, table, prow, heads)]}
        return want, paged, cut_params(params, grid)

    want, paged, local = in_turn(ring, draw_fp32)
    rec = {"prefill_fp32": gspmd_prefill(grid, device, model, batch, b32,
                                         params=local, want=want, aux=True)}
    mine = {"layers": [{k: v[:, :, heads[0]:heads[0] + heads[1]].clone()
                        for k, v in lay.items()} for lay in pool["layers"]]}
    leg_start(torch, device)
    plog, mine = make_paged_decode_step(model, grid)(
        local, ptok[prow], mine, table[prow], lengths[prow])
    got_pages = paged_mine(mine, table, prow, (0, heads[1]))
    rec["paged_fp32"] = leg_end(torch, device, {
        "rows": [prow.start, prow.stop], "kv_heads": list(heads),
        "max_abs_logits": rows_max_abs(plog, paged["logits"]),
        "max_abs_pages": max(rows_max_abs(g, w) for gl, wl in zip(
            got_pages, paged["pages"]) for g, w in zip(gl, wl))})
    del local, mine, pool, plog, got_pages, want, paged
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["serve_bf16"] = gspmd_serve(grid, device, model, dims["serve_b"],
                                    seq, dims["new"], ring=ring,
                                    one_rank_flash=False)
    return rec


def fam_ssm(grid, device, cfg, dims) -> dict:
    """SSM_ARCH on the 2x2 mesh: :func:`gspmd_prefill` of this rank's rows
    in fp32, then ``dims['ssm_decode']`` decode steps of fixed tokens, with
    the per-rank cache's shapes."""
    from repro_torch.models.model import build_model

    seq, rows = dims["seq"], dims["prefill_b"]
    mine = seeded_tokens(cfg, rows, seq + dims["ssm_decode"], device)[
        rows_of(grid, rows)]
    return gspmd_prefill(grid, device, build_model(cfg),
                         {"tokens": mine[:, :seq]}, rows,
                         decode=mine[:, seq:])


def fam_vlm(grid, ring, device, cfg, dims) -> dict:
    """VLM_ARCH on the 2x2 mesh in bf16 with its cross gates opened from
    VLM_GATE_SEED: :func:`gspmd_prefill` of this rank's rows with their
    patches (flash on its heads in the self-attention layers), beside the
    one-rank flash prefill; then the mesh prefill again with the gates
    closed, against the one-rank plain prefill with them open. One rank at
    a time draws the whole fp32 weights."""
    import torch

    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params

    model = build_model(cfg)
    cross = [i for i, c in enumerate(cfg.cross_attn_mask()) if c]
    seq, rows = dims["seq"], dims["prefill_b"]
    r = rows_of(grid, rows)
    gen = torch.Generator(device=device).manual_seed(2)
    batch = {"tokens": seeded_tokens(cfg, rows, seq, device)[r],
             "patch_embeds": torch.randn(
                 (rows, cfg.num_patches, cfg.vision_dim), generator=gen,
                 device=device)[r]}
    gates = torch.rand(len(cross), generator=torch.Generator().manual_seed(
        VLM_GATE_SEED)) * 0.5 + 0.5

    def draw():
        p32 = model.init(0, device=device)
        for i, g in zip(cross, gates.tolist()):
            p32.blocks[i]["cross_gate"].data.fill_(g)
        params = cast_params(p32, torch.bfloat16)
        del p32
        plain, flash = (prefill_run(model, params, m, batch)["logits"].cpu()
                        for m in (None, single_rank_mesh(("x",))))
        return {"logits": plain}, flash, cut_params(params, grid)

    want, one_flash, local = in_turn(ring, draw)
    rec = gspmd_prefill(grid, device, model, batch, rows, params=local,
                        want=want, keep=True)
    opened, local = rec.pop("logits"), rec.pop("params")
    rec["vs_one_rank_flash"] = flash_limit_share(opened, one_flash)
    rec["one_rank_flash_vs_plain"] = flash_limit_share(
        one_flash.to(device), want["logits"])
    for i in cross:
        local.blocks[i]["cross_gate"].data.zero_()
    closed = prefill_run(model, local, grid, batch, rows)["logits"]
    rec["closed_vs_one_rank_plain"] = flash_limit_share(closed,
                                                        want["logits"])
    rec["gate_open_vs_closed_max_abs"] = max_abs(opened, closed)
    rec["cross_layers"], rec["cross_gates"] = cross, gates.tolist()
    del local, opened, closed, want, one_flash
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def fam_whisper(grid, device, cfg, dims) -> dict:
    """WHISPER_ARCH on the 2x2 mesh: :func:`gspmd_prefill` in fp32 of this
    rank's rows of the train legs' first batch, frames and tokens."""
    import torch

    from repro_torch.models.model import build_model

    rows = dims["whisper_b"]
    r = rows_of(grid, rows)
    batch = fam_batches(cfg, rows, dims["whisper_s"], 1)[0]
    return gspmd_prefill(grid, device, build_model(cfg),
                         {k: torch.as_tensor(v)[r].to(device)
                          for k, v in batch.items()}, rows)


def fam_rank(mesh, device, dims, root):
    """Runs on every rank of phase gspmd_families: the GSPMD train legs
    (GSPMD_LEGS of each config of :func:`fam_train_legs`, weights written
    under ``root``), then, without gradients, the MoE, SSM, vlm and
    whisper serving legs on the 2x2 mesh."""
    import os

    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model

    if device == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
    grid = make_mesh(*GSPMD_MESH)
    cfgs = fam_cfgs(dims)
    out, t0 = {"train": {}, "seconds": {}}, time.perf_counter()

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        return now

    for name, (cfg, b, s) in fam_train_legs(cfgs, dims).items():
        model = build_model(cfg)
        batches = fam_batches(cfg, b, s, dims["steps"])
        for leg, fsdp in GSPMD_LEGS:
            out["train"][name, leg] = gspmd_train_leg(
                grid, device, model, batches, fsdp,
                os.path.join(root, f"{name}_{leg}"),
                moments=name in FAM_TINY_GRAD_LEGS)
        t0 = lap(f"train {name}")
    torch.set_grad_enabled(False)
    out["moe"] = fam_moe(grid, mesh, device, cfgs["moe"], dims)
    t0 = lap("moe")
    out["ssm"] = fam_ssm(grid, device, cfgs["ssm"], dims)
    t0 = lap("ssm")
    out["vlm"] = fam_vlm(grid, mesh, device, cfgs["vlm"], dims)
    t0 = lap("vlm")
    out["whisper"] = fam_whisper(grid, device, cfgs["whisper"], dims)
    lap("whisper")
    return out


def close_rel(a, b, rtol) -> bool:
    """Every x of ``a`` within relative ``rtol`` of its y in ``b``."""
    return all(abs(x / y - 1) <= rtol for x, y in zip(a, b))


def max_diff(xs, ys) -> float:
    """The largest |x - y| over pairs of tensors (x moved to y's device)."""
    return max(float((x.to(y.device) - y).abs().max()) if x.numel()
               else 0.0 for x, y in zip(xs, ys))


def hold_train_legs(torch, what, recs_by_leg, cfg, batches, device, root,
                    tiny_grad=None):
    """Each GSPMD train leg of ``recs_by_leg`` (leg -> every rank's
    record; weights written under ``root/<leg>``) against the one-rank
    step on the same batches from the same state: losses within rtol
    WHOLE_TOL[0], grad norms within WHOLE_TOL[1], the weights within
    WHOLE_TOL[2], and no kernel launched. Returns leg -> summary.

    With ``tiny_grad`` (the legs wrote their first moments too) the
    weights are held where the one-rank step's clipped gradient reached
    ``tiny_grad`` at every step, and the first moments everywhere within
    FAM_MU_ATOL: AdamW moves a weight by about lr g / (|g| + 1e-8), so
    where |g| is near 1e-8 the last bits of g, which the ranks' sums
    reorder, move the weight by a share of lr; the moments hold those
    gradients themselves."""
    import os
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig

    rtol_loss, rtol_gn, atol_w = WHOLE_TOL
    mus = [] if tiny_grad is not None else None
    one, one_gn, one_params = one_rank_steps(torch, cfg, batches, device,
                                             mus=mus)
    one_w = tree_flatten(one_params.tree())[0]
    held = None
    if mus:
        # each step's clipped gradient from its first moments:
        # mu_k = b1 mu_(k-1) + (1 - b1) g_k
        b1 = AdamWConfig().b1
        steps = [tree_flatten(m)[0] for m in mus]
        prev = [torch.zeros_like(t) for t in steps[0]]
        held = [torch.ones_like(t, dtype=torch.bool) for t in steps[0]]
        for cur in steps:
            for h, c, p in zip(held, cur, prev):
                h &= ((c - b1 * p) / (1 - b1)).abs() >= tiny_grad
            prev = cur
    none = dict.fromkeys(ops.KERNELS, 0)
    close = close_rel
    legs = {}
    for leg, recs in recs_by_leg.items():
        tag = f"{what}/{leg}"
        check(all(r["device"].startswith(device) for r in recs),
              f"{tag} ran on {[r['device'] for r in recs]}")
        check(all(close(r["loss"], one, rtol_loss) for r in recs),
              f"{tag}: losses {[r['loss'] for r in recs]} vs the one-rank "
              f"step's {one} beyond rtol {rtol_loss}")
        check(all(close(r["grad_norm"], one_gn, rtol_gn) for r in recs),
              f"{tag}: grad norms {[r['grad_norm'] for r in recs]} vs "
              f"{one_gn} beyond rtol {rtol_gn}")
        check(all(r["launches"] == none for r in recs),
              f"{tag}: launches {[r['launches'] for r in recs]}, want none "
              "(training takes the plain attention; native reduces "
              "through the library)")
        d = os.path.join(root, leg)
        like = {"params": one_params}
        if held is not None:
            like["mu"] = mus[-1]
        _, got, _ = ckpt.restore(d, like)
        got_w = tree_flatten(got["params"].tree())[0]
        summary = {}
        if held is None:
            err = max_diff(got_w, one_w)
        else:
            err = max(float((g.to(w.device) - w).abs()[h].max())
                      if h.any() else 0.0
                      for g, w, h in zip(got_w, one_w, held))
            mu_err = max_diff(tree_flatten(got["mu"])[0],
                              tree_flatten(mus[-1])[0])
            check(mu_err <= FAM_MU_ATOL,
                  f"{tag}: first moments {mu_err} from the one-rank "
                  f"step's, beyond {FAM_MU_ATOL}")
            summary = {
                "max_abs_mu_diff_vs_one_rank": mu_err,
                "mu_atol": FAM_MU_ATOL, "tiny_grad": tiny_grad,
                "weights_held": int(sum(int(h.sum()) for h in held)),
                "weights": int(sum(h.numel() for h in held)),
                "max_abs_weight_diff_all": max_diff(got_w, one_w)}
        check(err <= atol_w, f"{tag}: weights {err} from the one-rank "
                             f"step's, beyond {atol_w}")
        del got, got_w
        shutil.rmtree(d)
        legs[leg] = {
            "loss": recs[0]["loss"], "grad_norm": recs[0]["grad_norm"],
            "one_rank_loss": one, "one_rank_grad_norm": one_gn,
            "step_s": [max(r["seconds"][i] for r in recs)
                       for i in range(len(one))],
            "staged_bytes_per_rank_by_source": recs[0]["staged"],
            "peak_gb_per_rank": [r["peak_gb"] for r in recs],
            "max_abs_weight_diff_vs_one_rank": err, **summary}
    del one_params, one_w, mus, held
    if device == "cuda":
        torch.cuda.empty_cache()
    return legs


def run_gspmd_families(torch, device, dims,
                       timeout=FAM_TIMEOUT) -> dict:
    """Phase gspmd_families' legs on FAM_RANKS gloo processes, then, after
    they exit, the one-rank train steps in this process; every gate
    asserted. Returns the record (a ``dims`` with a width and
    ``device="cpu"`` make a probe on the CPU)."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_mesh

    cuda = device == "cuda"
    cfgs = fam_cfgs(dims)
    root = tempfile.mkdtemp(prefix="chip_smoke_fam_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_mesh(FAM_RANKS, fam_rank, device, dims, root,
                           axes=("x",), timeout=timeout)
        ranks_s = time.perf_counter() - t0
        serve = hold_family_serving(ranks, cfgs, cuda)
        train = {}
        for name, (cfg, b, s) in fam_train_legs(cfgs, dims).items():
            train[name] = hold_train_legs(
                torch, f"gspmd_families/{name}",
                {f"{name}_{leg}": [r["train"][name, leg] for r in ranks]
                 for leg, _ in GSPMD_LEGS},
                cfg, fam_batches(cfg, b, s, dims["steps"]), device, root,
                tiny_grad=FAM_TINY_GRAD if name in FAM_TINY_GRAD_LEGS
                else None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"seconds_ranks": ranks_s, "train": train,
            "leg_seconds": {k: max(r["seconds"][k] for r in ranks)
                            for k in ranks[0]["seconds"]}, **serve}


def hold_family_serving(ranks, cfgs, cuda: bool) -> dict:
    """Phase gspmd_families' serving gates over every rank's record, and
    their summary."""
    from repro_torch.kernels import ops

    # flash launches per rank: one per self-attention layer in a prefill on
    # the card; on the CPU the wrapper takes its plain version, uncounted
    moe_l = cfgs["moe"].num_layers if cuda else 0
    vlm_l = cfgs["vlm"].num_layers if cuda else 0
    none = dict.fromkeys(ops.KERNELS, 0)
    legs = {k: [r[k] for r in ranks] for k in ("moe", "ssm", "vlm",
                                                "whisper")}

    def hold_prefill(what, recs, n, route, share=None):
        # finite logits within FP32_PREFILL_ATOL of the one-rank plain
        # prefill's (bf16: within ``share`` of the bf16 flash limit), and
        # n flash launches on ``route`` and nothing else
        want = {**none, "flash_attention": n}
        for p in recs:
            v = p["vs_one_rank"]
            ok = (v["max_abs"] <= FP32_PREFILL_ATOL if share is None
                  else v["limit_share"] <= share)
            check(p["finite"] and ok,
                  f"gspmd_families/{what}: logits {v} from the one-rank "
                  "plain run's, beyond " + (
                      f"{FP32_PREFILL_ATOL}" if share is None else
                      f"{share} of atol {FLASH_ATOL['bfloat16']} + rtol "
                      f"{FLASH_RTOL} |want|"))
            check(p["launches"] == want
                  and p["flash_routes"] == ({route: n} if n else {}),
                  f"gspmd_families/{what}: launches {p['launches']} routes "
                  f"{p['flash_routes']}, want {n} flash on {route}")

    moe = legs["moe"]
    hold_prefill("moe fp32 prefill", [m["prefill_fp32"] for m in moe],
                 moe_l, "simt_f32")
    for m in moe:
        p, q = m["prefill_fp32"], m["paged_fp32"]
        check(p["dropped"] == p["dropped_one_rank"] and p["frac_equal"],
              f"gspmd_families/moe: dropped {p['dropped']} vs the one-rank "
              f"prefill's {p['dropped_one_rank']}, frac equal "
              f"{p['frac_equal']}")
        check(max(q["max_abs_logits"], q["max_abs_pages"])
              <= SERVE_MESH_ATOL and q["launches"] == none,
              f"gspmd_families/moe: paged step {q['max_abs_logits']} "
              f"(logits), {q['max_abs_pages']} (pages) from the one-rank "
              f"step's, beyond {SERVE_MESH_ATOL}; launches {q['launches']}")
    hold_serve("gspmd_families/moe bf16", [m["serve_bf16"] for m in moe],
               moe_l, min_within=FAM_MOE_BF16_WITHIN)
    hold_prefill("ssm prefill and decode", legs["ssm"], 0, "simt_f32")
    hold_prefill("vlm bf16 prefill", legs["vlm"], vlm_l, "wgmma_bf16",
                 share=FAM_VLM_BF16_SHARE)
    for v in legs["vlm"]:
        # FAM_VLM_BF16_SHARE is set from readings at full width; a CPU
        # probe's narrow cross branch moves the logits by less
        c = v["closed_vs_one_rank_plain"]
        check(v["gate_open_vs_closed_max_abs"] > 0
              and (c["limit_share"] > FAM_VLM_BF16_SHARE or not cuda),
              f"gspmd_families/vlm: with the cross gates closed the logits "
              f"are {c} from the one-rank plain prefill's with them open, "
              f"within the limit {FAM_VLM_BF16_SHARE} that holds the open "
              "prefill (which then could not tell that the cross branch "
              "ran)")
    hold_prefill("whisper prefill", legs["whisper"], 0, "simt_f32")

    def figures(recs):
        # every rank's staged bytes by source, peak memory and flash
        # launches
        return {"staged_per_rank": [r["staged"] for r in recs],
                "peak_gb_per_rank": [r["peak_gb"] for r in recs],
                "flash_per_rank": [r["launches"]["flash_attention"]
                                   for r in recs]}

    def prefill(recs, *keys):
        return {**figures(recs), "seconds": max(r["seconds"] for r in recs),
                "max_abs_vs_one_rank": max(
            r["max_abs_vs_one_rank"] for r in recs),
                **{k: [r[k] for r in recs] for k in keys}}

    serve = [m["serve_bf16"] for m in moe]
    pre16 = [s["prefill"] for s in serve]
    vlm_keys = ("vs_one_rank", "vs_one_rank_flash", "one_rank_flash_vs_plain",
                "closed_vs_one_rank_plain")
    out = {
        "moe": {"prefill_fp32": prefill([m["prefill_fp32"] for m in moe],
                                        "dropped"),
                "paged_fp32": {"max_abs_logits": max(
                    m["paged_fp32"]["max_abs_logits"] for m in moe),
                    "max_abs_pages": max(m["paged_fp32"]["max_abs_pages"]
                                         for m in moe),
                    "atol": SERVE_MESH_ATOL},
                "generate_bf16": figures([s["generate"] for s in serve]),
                "prefill_bf16": {**figures(pre16), "seconds": max(
                    p["seconds"] for p in pre16), "vs_one_rank_plain": [
                        p["vs_one_rank_plain"] for p in pre16],
                                 "min_within_share": FAM_MOE_BF16_WITHIN},
                "decode_bf16": {"ms_p50": max(s["decode"]["ms_p50"]
                                              for s in serve),
                                "staged_per_rank": [s["decode"]["staged"]
                                                    for s in serve],
                                "flash_per_rank": [s["decode"]["launches"][
                                    "flash_attention"] for s in serve]}},
        "ssm": {**prefill(legs["ssm"]), "decode_ms_p50": max(
            s["decode_ms_p50"] for s in legs["ssm"]),
                "cache_shapes_rank0": legs["ssm"][0]["cache_shapes"][:1]},
        "vlm": {**prefill(legs["vlm"], *vlm_keys),
                "bf16_limit": f"{FAM_VLM_BF16_SHARE} x (atol "
                              f"{FLASH_ATOL['bfloat16']} + rtol "
                              f"{FLASH_RTOL} |want|)",
                "gate_open_vs_closed_max_abs": min(
                    v["gate_open_vs_closed_max_abs"] for v in legs["vlm"]),
                "cross_layers": legs["vlm"][0]["cross_layers"]},
        "whisper": prefill(legs["whisper"])}
    out["flash_per_rank"] = {
        "qwen3-moe prefill fp32": out["moe"]["prefill_fp32"]["flash_per_rank"],
        "qwen3-moe generate bf16": out["moe"]["generate_bf16"][
            "flash_per_rank"],
        "qwen3-moe prefill bf16": out["moe"]["prefill_bf16"]["flash_per_rank"],
        "qwen3-moe decode bf16": out["moe"]["decode_bf16"]["flash_per_rank"],
        "mamba2 prefill+decode": out["ssm"]["flash_per_rank"],
        "vlm prefill bf16": out["vlm"]["flash_per_rank"],
        "whisper prefill": out["whisper"]["flash_per_rank"]}
    return out


def phase_gspmd_families(torch, card: str) -> dict:
    """The MoE, SSM, vlm and encoder-decoder families on the GSPMD
    placement of a 2x2 mesh, FAM_RANKS processes sharing the card over
    gloo, every result against the one-rank result on the same weights;
    returns each leg's flash launches per rank."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = run_gspmd_families(torch, "cuda", FAM_DIMS)
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the gspmd_families phase")
    cfgs = fam_cfgs(FAM_DIMS)
    head = {"phase": "gspmd_families", "card": card, "ranks": FAM_RANKS,
            "mesh": {"shape": GSPMD_MESH[0], "names": GSPMD_MESH[1]}}
    for name, legs in rec["train"].items():
        emit({**head, "leg": f"train {name}",
              "config": fam_train_legs(cfgs, FAM_DIMS)[name][0].name,
              "global_batch": list(fam_train_legs(cfgs, FAM_DIMS)[name][1:]),
              "steps": FAM_DIMS["steps"], "dtype": "float32",
              "tolerances": {"loss_rtol": WHOLE_TOL[0],
                             "grad_norm_rtol": WHOLE_TOL[1],
                             "weights_atol": WHOLE_TOL[2]}, "legs": legs})
    emit({**head, "leg": "qwen3-moe serve",
          "cut": f"depth only: {FAM_DIMS['moe_layers']} of 94 layers at "
                 "full width (random weights, seed 0)",
          "prefill_fp32_batch": [FAM_DIMS["prefill_b"], FAM_DIMS["seq"]],
          "generate_bf16_batch": [FAM_DIMS["serve_b"], FAM_DIMS["seq"],
                                  FAM_DIMS["new"]],
          "paged_slots": FAM_DIMS["paged_slots"], **rec["moe"]})
    emit({**head, "leg": "mamba2-130m serve",
          "batch": [FAM_DIMS["prefill_b"], FAM_DIMS["seq"]],
          "decode_steps": FAM_DIMS["ssm_decode"], **rec["ssm"]})
    emit({**head, "leg": "llama-3.2-vision-90b prefill",
          "cut": f"depth only: {FAM_DIMS['vlm_layers']} of 100 layers (one "
                 "period, the cross layer last) at full width",
          "batch": [FAM_DIMS["prefill_b"], FAM_DIMS["seq"]],
          "patches": [cfgs["vlm"].num_patches, cfgs["vlm"].vision_dim],
          **rec["vlm"]})
    emit({**head, "leg": "whisper-base prefill",
          "batch": [FAM_DIMS["whisper_b"], FAM_DIMS["whisper_s"]],
          "frames": cfgs["whisper"].audio_ctx, **rec["whisper"]})
    emit({**head, "leg": "summary", "flash_per_rank": rec["flash_per_rank"],
          "card_free_gb_at_start": free_gb,
          "transport": "gloo, staged through host memory; kernels on the "
                       "card",
          "staged_bytes_note": "per rank, by source (partition.SOURCES)",
          "gates": "ok",
          "seconds": {"ranks": rec["seconds_ranks"],
                      "legs_slowest_rank": rec["leg_seconds"],
                      "phase": time.perf_counter() - t0},
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})
    return rec["flash_per_rank"]


def serve_mesh_cfgs(dims):
    """(SERVE_ARCH, MOE_ARCH) configs in fp32 for phase serve_mesh's
    ``dims``: at full width cut in depth, or reduced to ``dims[1]`` (a
    probe on the CPU)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    out = []
    for arch, layers in ((SERVE_ARCH, dims[0]), (MOE_ARCH, dims[7])):
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=layers) if dims[1] is None \
            else reduced(cfg, layers=layers, d_model=dims[1])
        out.append(dataclasses.replace(cfg, dtype="float32"))
    return out


def serve_mesh_prompts(cfg, dims, n: int, seed: int):
    """``n`` prompts of ``dims[3]`` tokens (uniform, numpy ``seed``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = dims[3]
    return [rng.integers(0, cfg.vocab_size, size=(int(k),)).astype(np.int32)
            for k in rng.integers(lo, hi + 1, size=n)]


def serve_mesh_pcfg(dims, slots: int, new: int):
    from repro_torch.models.kvcache import PagedCacheConfig

    max_seq = dims[3][1] + new
    return PagedCacheConfig(page_size=ENGINE_PAGE, num_pages=slots * (
        -(-max_seq // ENGINE_PAGE)), max_slots=slots, max_seq=max_seq)


def one_rank_decode(torch, model, params, dims, device, seed: int) -> dict:
    """The one-rank paged decode from committed prefill pages: the
    prompts of every slot, the whole pool before and after, and per step
    the block table, lengths, fed tokens, logits and seconds. Counts the
    MoE routing's dropped slots (``moe._dispatch_indices``)."""
    from repro_torch.benchmarks.serve_bench import prefill_pages
    from repro_torch.models import moe
    from repro_torch.train.serve import make_paged_decode_step

    slots, steps = dims[2], dims[4]
    prompts = serve_mesh_prompts(model.cfg, dims, slots, seed)
    pcfg = serve_mesh_pcfg(dims, slots, steps)
    pages, alloc, tok = prefill_pages(model, params, pcfg, prompts, steps,
                                      device)
    rec = {"pages0": [{k: v.to("cpu", copy=True) for k, v in layer.items()}
                      for layer in pages["layers"]],
           "tables": [], "toks": [], "logits": [], "seconds": []}
    step = make_paged_decode_step(model, None)
    drops, orig = [0], moe._dispatch_indices

    def counting(*a):
        got = orig(*a)
        drops[0] += int((~got[2]).sum())
        return got

    moe._dispatch_indices = counting
    try:
        for _ in range(steps):
            bt, ln = alloc.device_tables(device)
            rec["tables"].append((bt.cpu(), ln.cpu()))
            rec["toks"].append(tok.cpu())
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, pages = step(params, tok, pages, bt, ln)
            if device == "cuda":
                torch.cuda.synchronize()
            rec["seconds"].append(time.perf_counter() - t0)
            rec["logits"].append(lg[:, 0].cpu())
            for s in range(slots):
                alloc.append(s)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    finally:
        moe._dispatch_indices = orig
    rec["pages"] = [{k: v.cpu() for k, v in layer.items()}
                    for layer in pages["layers"]]
    rec["dropped"] = drops[0]
    rec["prompt_tokens"] = [int(p.shape[0]) for p in prompts]
    return rec


def explicit_step_leg(torch, mesh, model, params, oracle, schedule,
                      device) -> dict:
    """The explicit step on this rank on ``schedule`` (None: the engine's
    auto), given this rank's part of the weights ``params``, from the
    oracle's pages cut to this rank's KV heads, the
    oracle's tables and its rows of the fed tokens: max |dlogits| over its
    rows, max |dpages| over its pool, per-step seconds (from a barrier to
    the drained card), launches, dropped MoE slots and bytes staged by
    callsite per step."""
    import torch.distributed as dist

    from repro_torch.comm.callsites import DECODE_QKV
    from repro_torch.comm.engine import (CollectiveEngine,
                                         reset_staged_bytes,
                                         staged_bytes_by_callsite)
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.kvcache import pool_heads
    from repro_torch.train.serve import decode_rows, make_decode_step_explicit

    cfg = model.cfg
    steps = len(oracle["tables"])
    slots = oracle["tables"][0][0].shape[0]
    rows = decode_rows(mesh, slots, "x")
    start, count = pool_heads(cfg, mesh, "x")
    pages = {"layers": [{k: v.narrow(2, start, count).contiguous().to(
        device, copy=True) for k, v in layer.items()}
                        for layer in oracle["pages0"]]}
    engine = CollectiveEngine.for_mesh(mesh, schedule=schedule or "auto")
    step = make_decode_step_explicit(model, mesh, engine=engine,
                                     schedule=schedule)
    drops, orig = [0], moe._dispatch_indices

    def counting(*a):
        got = orig(*a)
        drops[0] += int((~got[2]).sum())
        return got

    rec = {"seconds": [], "max_abs_logits": 0.0}
    moe._dispatch_indices = counting
    ops.reset_launch_counts()
    reset_staged_bytes()
    try:
        for i in range(steps):
            bt, ln = (t.to(device) for t in oracle["tables"][i])
            tok = oracle["toks"][i][rows].to(device)
            dist.barrier()
            t0 = time.perf_counter()
            lg, pages = step(params, tok, pages, bt, ln)
            if device == "cuda":
                torch.cuda.synchronize()
            rec["seconds"].append(time.perf_counter() - t0)
            rec["max_abs_logits"] = max(rec["max_abs_logits"], max_abs(
                lg[:, 0], oracle["logits"][i][rows].to(device)))
            rec["finite"] = bool(torch.isfinite(lg).all())
    finally:
        moe._dispatch_indices = orig
    rec["launches"] = ops.launch_counts()
    rec["staged_per_step"] = {str(k): v // steps for k, v in
                              staged_bytes_by_callsite().items()}
    rec["max_abs_pages"] = max(
        max_abs(got[k], want[k].narrow(2, start, count).to(device))
        for got, want in zip(pages["layers"], oracle["pages"]) for k in got)
    rec["dropped"] = drops[0]
    qkv = (rows.stop - rows.start) * cfg.num_heads * cfg.head_dim * 4
    rec["resolved"] = engine.schedule_for(
        "all_to_all_tiles", schedule, nbytes=qkv, axis="x",
        callsite=DECODE_QKV)
    return rec


def mesh_engine_leg(torch, mesh, model, params, prompts, pcfg, mode: str,
                    new: int, device, dtype=None) -> dict:
    """One ``ServeEngine.run`` on this rank (``mode`` on ``mesh``): the
    streams, per-step decode and prefill seconds, wall seconds (from a
    barrier), launches, bytes staged by callsite and peak memory."""
    import torch.distributed as dist

    from repro_torch.comm.engine import (reset_staged_bytes,
                                         staged_bytes_by_callsite)
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    reset_staged_bytes()
    eng = ServeEngine(model, params, pcfg, mode=mode, mesh=mesh,
                      dtype=dtype or torch.float32)
    dist.barrier()
    t0 = time.perf_counter()
    out, stats = eng.run(prompts, max_new_tokens=new, collect_stats=True)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"streams": {r: v.tolist() for r, v in out.items()},
            "decode_s": [st["decode_s"] for st in stats
                         if st["decode_tokens"]],
            "prefill_s": sum(st.get("prefill_s", 0.0) for st in stats),
            "prefills": sum(st["prefills"] for st in stats),
            "generated": sum(st["decode_tokens"] + st["prefills"]
                             for st in stats),
            "wall_s": wall, "launches": ops.launch_counts(),
            "staged": {str(k): v for k, v in
                       staged_bytes_by_callsite().items()},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else None}


def serve_mesh_rank(mesh, device, dims, root):
    """Runs on every rank of phase serve_mesh: the explicit step legs of
    SERVE_ARCH (the one-rank oracle in this process too: every rank holds
    the whole weights and hands the step views of its part), the explicit
    and the 2x2 GSPMD engine in fp32, the explicit engine in bf16, then
    the MoE step leg against the parent's
    oracle under ``root``, each rank keeping its experts."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import sharding as sh
    from repro_torch.comm.engine import schedules_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params
    from repro_torch.train.serve import local_params
    from repro_torch.train.step import whole_model_param_specs

    torch.set_grad_enabled(False)
    if device == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
    grid = make_mesh(*GSPMD_MESH)
    cfg, moe_cfg = serve_mesh_cfgs(dims)
    model = build_model(cfg)
    params = model.init(0, device=device)
    oracle = one_rank_decode(torch, model, params, dims, device, ENGINE_SEED)
    out = {"one_rank_step_s": oracle["seconds"], "steps": {}}
    mine = local_params(params, mesh, "x")
    for s in sorted(schedules_for("all_to_all_tiles")) + [None]:
        out["steps"][s or "auto"] = explicit_step_leg(
            torch, mesh, model, mine, oracle, s, device)
    del oracle, mine
    prompts = serve_mesh_prompts(cfg, dims, dims[5], ENGINE_SEED)
    pcfg = serve_mesh_pcfg(dims, dims[2], dims[6])
    out["explicit"] = mesh_engine_leg(torch, mesh, model, params, prompts,
                                      pcfg, "explicit", dims[6], device)
    out["gspmd"] = mesh_engine_leg(torch, grid, model, params, prompts,
                                   pcfg, "gspmd", dims[6], device)
    bf = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    params = cast_params(params, torch.bfloat16)  # the fp32 copy goes
    out["bf16"] = mesh_engine_leg(torch, mesh, bf, params, prompts, pcfg,
                                  "explicit", dims[6], device,
                                  dtype=torch.bfloat16)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()

    # the MoE layer: each rank in turn draws it whole and keeps its experts
    moe = build_model(moe_cfg)
    ax = mesh.axis("x")
    for turn in range(ax.size):
        if turn == ax.index:
            whole = moe.init(0, device=device)
            local = type(whole)(moe_cfg, sh.cut(
                whole.tree(), whole_model_param_specs(whole, "x"), mesh))
            del whole
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    oracle = torch.load(os.path.join(root, "moe.pt"))
    out["moe"] = explicit_step_leg(torch, mesh, moe, local, oracle, None,
                                   device)
    out["moe"]["experts_local"] = int(
        local.blocks[0]["moe"]["w_gate"].shape[0])
    return out


def first_divergence(got, want) -> int:
    """The first index at which two token lists differ (-1: equal)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return -1 if len(got) == len(want) else min(len(got), len(want))


def one_rank_engine(torch, model, params, prompts, pcfg, new: int,
                    device) -> dict:
    """The one-rank fp32 engine on ``prompts``, recording for every decode
    step's active slot the gap between its two largest logits, keyed by
    (request, index of the token sampled from them)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(model, params, pcfg, dtype=torch.float32)
    decode, gaps = eng._decode, {}

    def recording(p, tokens, pages, bt, lengths):
        logits, pages = decode(p, tokens, pages, bt, lengths)
        top = torch.topk(logits[:, 0].float(), 2, dim=-1).values.cpu()
        at = lengths.cpu().tolist()
        for slot, req in eng.scheduler.active.items():
            gaps[req.rid, at[slot] + 1] = float(top[slot, 0] - top[slot, 1])
        return logits, pages

    eng._decode = recording
    out = eng.run(prompts, max_new_tokens=new)
    return {"streams": {r: v.tolist() for r, v in out.items()},
            "gaps": gaps}


def engine_gate(name, recs, want, gaps, atol) -> list:
    """Each rank's streams against the one-rank engine's: token-identical,
    or the first divergence at a decode step whose top-2 logit gap in the
    one-rank engine is below ``atol`` (a near-tie). Returns the near-ties
    and fails on anything else."""
    ties = []
    for r, rec in enumerate(recs):
        check(set(rec["streams"]) == set(want),
              f"serve_mesh/{name} rank {r}: requests "
              f"{sorted(rec['streams'])}")
        for rid, seq in want.items():
            d = first_divergence(rec["streams"][rid], seq)
            if d < 0:
                continue
            gap = gaps.get((rid, d))
            check(gap is not None and gap < atol,
                  f"serve_mesh/{name} rank {r}: request {rid} diverges at "
                  f"token {d} where the one-rank engine's top-2 gap is "
                  f"{gap}, not a near-tie below {atol}")
            ties.append({"rank": r, "request": rid, "token": d, "gap": gap})
    return ties


def run_serve_mesh(torch, device, dims, timeout=SERVE_MESH_TIMEOUT) -> dict:
    """Phase serve_mesh's legs: the MoE oracle and the one-rank engine in
    this process, then SERVE_MESH_RANKS gloo processes, then
    failover_bench's serve rank loss; every gate asserted. Returns the
    record (``dims`` smaller than SERVE_MESH_DIMS and ``device="cpu"``
    make a probe on the CPU)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.benchmarks import failover_bench
    from repro_torch.comm.engine import schedules_for
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.models.model import build_model

    cuda = device == "cuda"
    cfg, moe_cfg = serve_mesh_cfgs(dims)
    none = dict.fromkeys(ops.KERNELS, 0)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_")
    try:
        t0 = time.perf_counter()
        moe = build_model(moe_cfg)
        with torch.no_grad():
            params = moe.init(0, device=device)
            moe_oracle = one_rank_decode(torch, moe, params, dims, device,
                                         ENGINE_SEED + 1)
        del params
        torch.save(moe_oracle, os.path.join(root, "moe.pt"))
        model = build_model(cfg)
        prompts = serve_mesh_prompts(cfg, dims, dims[5], ENGINE_SEED)
        pcfg = serve_mesh_pcfg(dims, dims[2], dims[6])
        with torch.no_grad():
            params = model.init(0, device=device)
            one = one_rank_engine(torch, model, params, prompts, pcfg,
                                  dims[6], device)
        del params
        if cuda:
            torch.cuda.empty_cache()
        oracle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_mesh(SERVE_MESH_RANKS, serve_mesh_rank, device, dims,
                           root, axes=("x",), timeout=timeout)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    atol = SERVE_MESH_ATOL
    legs = {}
    for name in sorted(schedules_for("all_to_all_tiles")) + ["auto"]:
        recs = [r["steps"][name] for r in ranks]
        for r, rec in enumerate(recs):
            check(rec["finite"] and rec["max_abs_logits"] <= atol
                  and rec["max_abs_pages"] <= atol,
                  f"serve_mesh/step {name} rank {r}: logits "
                  f"{rec['max_abs_logits']}, pages {rec['max_abs_pages']} "
                  f"from the one-rank step's, beyond {atol}")
            check(rec["launches"] == none,
                  f"serve_mesh/step {name} rank {r}: launches "
                  f"{rec['launches']}")
            check(rec["resolved"] in schedules_for("all_to_all_tiles"),
                  f"serve_mesh/step {name}: resolved {rec['resolved']}")
        legs[name] = {
            "max_abs_logits": max(r["max_abs_logits"] for r in recs),
            "max_abs_pages": max(r["max_abs_pages"] for r in recs),
            "resolved": recs[0]["resolved"],
            # steady state: the slowest rank, the first step carrying
            # the warm-up
            "step_ms": [max(r["seconds"][i] for r in recs) * 1e3
                        for i in range(dims[4])],
            "staged_bytes_per_rank_per_step": recs[0]["staged_per_step"]}
    one_ms = [max(r["one_rank_step_s"][i] for r in ranks) * 1e3
              for i in range(dims[4])]

    mrecs = [r["moe"] for r in ranks]
    for r, rec in enumerate(mrecs):
        check(rec["finite"] and rec["max_abs_logits"] <= atol
              and rec["max_abs_pages"] <= atol,
              f"serve_mesh/moe rank {r}: logits {rec['max_abs_logits']}, "
              f"pages {rec['max_abs_pages']}, beyond {atol}")
        check(rec["launches"] == none,
              f"serve_mesh/moe rank {r}: launches {rec['launches']}")
        check(rec["dropped"] == 0 and moe_oracle["dropped"] == 0,
              f"serve_mesh/moe: {rec['dropped']} (rank {r}) and "
              f"{moe_oracle['dropped']} (one rank) routed slots dropped at "
              "decode")
        check(rec["experts_local"] * SERVE_MESH_RANKS == moe_cfg.num_experts,
              f"serve_mesh/moe rank {r} held {rec['experts_local']} experts")

    want = one["streams"]
    ties = {}
    for name in ("explicit", "gspmd", "bf16"):
        recs = [r[name] for r in ranks]
        for r, rec in enumerate(recs):
            check(rec["launches"] == none,
                  f"serve_mesh/{name} engine rank {r}: launches "
                  f"{rec['launches']}, want none (decode and the mesh-free "
                  "prefill take no kernel, C7)")
            check(rec["generated"] == dims[5] * dims[6],
                  f"serve_mesh/{name} rank {r}: {rec['generated']} tokens")
            check(rec["streams"] == recs[0]["streams"],
                  f"serve_mesh/{name}: rank {r}'s streams differ from rank "
                  "0's")
        if name != "bf16":
            ties[name] = engine_gate(name, recs, want, one["gaps"], atol)
    for name, found in ties.items():
        for t in found:
            print(f"serve_mesh/{name}: near-tie {t}", flush=True)

    b = [r["bf16"] for r in ranks]
    lat = sorted(max(r["decode_s"][i] for r in b)
                 for i in range(min(len(r["decode_s"]) for r in b)))
    bf16 = {"generated_tokens_per_s": dims[5] * dims[6]
            / max(r["wall_s"] for r in b),
            "decode_ms_p50": lat[len(lat) // 2] * 1e3,
            "decode_ms_p99": lat[min(int(len(lat) * 0.99),
                                     len(lat) - 1)] * 1e3,
            "prefill_s_per_request": max(r["prefill_s"] / r["prefills"]
                                         for r in b),
            "peak_gb_per_rank": [r["peak_gb"] for r in b],
            "staged_bytes_per_rank": b[0]["staged"]}

    # every kernel's launches in the decode and engine legs, per rank: the
    # counts each leg read from ops.launch_counts() (all asserted 0 above)
    legs_by_rank = [[*r["steps"].values(), r["moe"], r["explicit"],
                     r["gspmd"], r["bf16"]] for r in ranks]
    launches = {k: [sum(leg["launches"][k] for leg in legs)
                    for legs in legs_by_rank] for k in ops.KERNELS}

    sr = failover_bench.serve_rank_loss_section(device)
    bad = failover_bench.gate_serve_rank_loss(sr)
    check(not bad, f"serve_mesh/serve_rank_loss: {bad}")
    engines = {name: {
        "wall_s": max(r[name]["wall_s"] for r in ranks),
        "decode_ms_p50": sorted(ranks[0][name]["decode_s"])[
            len(ranks[0][name]["decode_s"]) // 2] * 1e3,
        "staged_bytes_per_rank": ranks[0][name]["staged"],
        "peak_gb_per_rank": [r[name]["peak_gb"] for r in ranks],
        "token_identical": not ties[name], "near_ties": ties[name]}
        for name in ("explicit", "gspmd")}
    return {"steps": legs, "one_rank_step_ms": one_ms,
            "moe": {"max_abs_logits": max(r["max_abs_logits"] for r in mrecs),
                    "max_abs_pages": max(r["max_abs_pages"] for r in mrecs),
                    "resolved": mrecs[0]["resolved"],
                    "dropped": [r["dropped"] for r in mrecs],
                    "dropped_one_rank": moe_oracle["dropped"],
                    "experts_per_rank": mrecs[0]["experts_local"],
                    "step_ms": [max(r["seconds"][i] for r in mrecs) * 1e3
                                for i in range(dims[4])],
                    "one_rank_step_ms": [t * 1e3
                                         for t in moe_oracle["seconds"]],
                    "staged_bytes_per_rank_per_step":
                        mrecs[0]["staged_per_step"]},
            "engines": engines, "bf16": bf16,
            "serve_rank_loss": {k: sr[k] for k in (
                "devices", "requests", "drained", "tokens_lost",
                "token_identical", "ranks_agree", "device")},
            "params": [cfg.param_count(), moe_cfg.param_count()],
            "prompt_tokens": [int(p.shape[0]) for p in prompts],
            "launches": launches, "seconds_oracles": oracle_s,
            "seconds_ranks": ranks_s, "atol": atol,
            "finite": bool(np.isfinite(
                moe_oracle["logits"][-1].numpy()).all())}


def phase_serve_mesh(torch, card: str) -> int:
    """The explicit half of serving on SERVE_MESH_RANKS processes sharing
    the card, every gate asserted; returns the kernel launches of its
    decode and engine legs, kernel by kernel and rank by rank, as each leg
    measured them (0, asserted)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = run_serve_mesh(torch, "cuda", SERVE_MESH_DIMS)
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the serve_mesh phase")
    emit({"phase": "serve_mesh", "card": card,
          "arch": [f"{SERVE_ARCH} at full width cut to {SERVE_MESH_LAYERS} "
                   "layers", f"{MOE_ARCH} at full width cut to "
                   f"{SERVE_MESH_MOE_LAYERS} layer"],
          "params": rec["params"], "ranks": SERVE_MESH_RANKS,
          "dtype": "float32", "slots": SERVE_MESH_SLOTS,
          "decode_steps": SERVE_MESH_STEPS, "page_size": ENGINE_PAGE,
          "prompt_tokens": ENGINE_PROMPT, "requests": ENGINE_REQUESTS,
          "new_tokens": SERVE_NEW, "atol_logits_and_pages": rec["atol"],
          "explicit_step": rec["steps"],
          "one_rank_step_ms": rec["one_rank_step_ms"],
          "moe_step": rec["moe"], "engines_fp32": rec["engines"],
          "explicit_engine_bf16": rec["bf16"],
          "serve_rank_loss": rec["serve_rank_loss"],
          "kernel_launches_in_decode_and_engine_legs_per_rank": [
              sum(v[r] for v in rec["launches"].values())
              for r in range(SERVE_MESH_RANKS)],
          "transport": "gloo, staged through host memory; the step's "
                       "compute on the card",
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate",
          "gates": "ok",
          "seconds": {"oracles": rec["seconds_oracles"],
                      "ranks": rec["seconds_ranks"],
                      "phase": time.perf_counter() - t0}})
    return rec["launches"]


def launch_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def launch_proc(args, out_dir: Path, name: str):
    """``python -m <args>`` from the repository's root, its output into
    ``out_dir/logs/name.log``."""
    (out_dir / "logs").mkdir(exist_ok=True)
    log = open(out_dir / "logs" / f"{name}.log", "w")
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                            env=launch_env(), stdout=log,
                            stderr=subprocess.STDOUT), log


def launch_wait(procs, timeout: float) -> dict:
    """Wait for every ``name -> (proc, log)`` of ``procs``; kill the ones
    past ``timeout`` seconds. Each one's exit code and output."""
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for name, (proc, log) in procs.items():
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.close()
            out[name] = (rc, Path(log.name).read_text())
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return out


def launch_direct(torch, lr: float) -> list:
    """TRAIN_ARCH at full size, LAUNCH_STEPS steps of ``train_loop`` on the
    card from configs written out from LAUNCH_ARGS by hand (not through
    the launcher's parser): the losses."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data import DataConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop

    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(comm_type="ici_direct", microbatches=1, remat="full",
                    learning_rate=lr,
                    warmup_steps=max(LAUNCH_STEPS // 10, 1),
                    checkpoint_dir=None, checkpoint_every=50)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=TRAIN_B,
                      seq_len=TRAIN_S)
    hist = train_loop(cfg, run, data, TrainLoopConfig(steps=LAUNCH_STEPS),
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return hist["loss"]


def rel_err(got, want) -> float:
    return max(abs(a / b - 1) for a, b in zip(got, want))


def phase_launch(torch, card: str) -> dict:
    """The entry points a user starts the port through, each a process of
    its own on the card: the training launcher at full size (gated
    against a direct ``train_loop``), ``examples.hpcc_suite`` (every
    row's gate, its kernels' launches equal to what its sizes imply),
    ``quickstart``, ``serve_lm`` twice (the same greedy tokens),
    ``train_lm``, and the dry run of one production cell, run alongside
    the others from the start (its host time is the phase's longest).
    Returns the hpcc_suite's launches by kernel."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.roofline import H100_BF16_PEAK_FLOPS, model_flops_for

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    dry = {"dryrun": launch_proc(("repro_torch.launch.dryrun",
                                  *LAUNCH_DRYRUN, "--out",
                                  str(tmp / "dryrun")), tmp, "dryrun")}
    try:
        # the launcher alone on the card: its step time is phase train's
        got = launch_wait({"train": launch_proc(
            ("repro_torch.launch.train", *LAUNCH_ARGS), tmp, "train")},
            LAUNCH_TIMEOUT)
        rc, text = got["train"]
        check(rc == 0, f"launch.train exited with {rc}:\n{text[-3000:]}")
        rec = json.loads(next(line[len("record: "):]
                              for line in text.splitlines()
                              if line.startswith("record: ")))
        losses = rec["losses"]
        check(len(losses) == LAUNCH_STEPS
              and all(math.isfinite(x) for x in losses),
              f"launch.train: losses {losses}")
        check(losses[-1] < losses[0], f"launch.train: the last loss "
              f"{losses[-1]} is not below the first {losses[0]}")
        params = get_config(TRAIN_ARCH).param_count()
        check(rec["params"] == params == LAUNCH_PARAMS,
              f"launch.train trained {rec['params']} parameters; "
              f"{TRAIN_ARCH} has {params}, expected {LAUNCH_PARAMS}")
        check(all(v == 0 for v in rec["kernel_launches"].values()),
              f"launch.train launched kernels: {rec['kernel_launches']}")
        t_direct = time.perf_counter()
        direct = launch_direct(torch, LAUNCH_LR)
        doubled = launch_direct(torch, 2 * LAUNCH_LR)
        t_direct = time.perf_counter() - t_direct
        err, err_doubled = rel_err(losses, direct), rel_err(losses, doubled)
        check(err <= LAUNCH_LOSS_RTOL,
              f"launch.train's losses {losses} differ from a direct "
              f"train_loop's {direct} by {err} > {LAUNCH_LOSS_RTOL}")
        check(err_doubled > LAUNCH_LOSS_RTOL,
              f"the limit {LAUNCH_LOSS_RTOL} does not reject a run at twice "
              f"the learning rate: {doubled} vs {losses} ({err_doubled})")

        # the examples share the card
        ckpt = tmp / "train_lm"
        examples = {
            "hpcc_suite": ("repro_torch.examples.hpcc_suite",),
            "quickstart": ("repro_torch.examples.quickstart",),
            "serve_lm_1": ("repro_torch.examples.serve_lm",),
            "serve_lm_2": ("repro_torch.examples.serve_lm",),
            "train_lm": ("repro_torch.examples.train_lm", "--steps",
                         str(LAUNCH_TRAIN_LM_STEPS), "--ckpt", str(ckpt))}
        ran = launch_wait({k: launch_proc(v, tmp, k)
                           for k, v in examples.items()}, LAUNCH_TIMEOUT)
        for name, (rc, text) in ran.items():
            check(rc == 0, f"{name} exited with {rc}:\n{text[-3000:]}")
        suite = json.loads(next(line for line in
                                ran["hpcc_suite"][1].splitlines()
                                if line.startswith('{"hpcc_suite"')))
        rows = suite["hpcc_suite"]
        check(all(r["ok"] for r in rows),
              f"hpcc_suite gates: {[r for r in rows if not r['ok']]}")
        for r in rows:
            exp = r["expected_launches"]
            check(r["launches"] == exp and all(v > 0 for v in exp.values()),
                  f"hpcc_suite {r['benchmark']}/{r['backend']} launched "
                  f"{r['launches']}, its sizes imply {exp}")
        hpcc = {k: sum(r["launches"].get(k, 0) for r in rows)
                for k in ops.KERNELS}
        for k in ops.KERNELS:
            if k not in ("flash_attention", "ring_add_step"):
                check(hpcc[k] > 0, f"hpcc_suite launched no {k}")
        greedy = [[line for line in ran[k][1].splitlines()
                   if line.startswith("  first row:")][0]
                  for k in ("serve_lm_1", "serve_lm_2")]
        check(greedy[0] == greedy[1],
              f"serve_lm's greedy tokens differ between runs: {greedy}")

        rc, text = launch_wait(dry, LAUNCH_TIMEOUT)["dryrun"]
        check(rc == 0, f"launch.dryrun exited with {rc}:\n{text[-3000:]}")
        cell = json.loads(next(line for line in text.splitlines()
                               if line.startswith('{"arch"')))
        check(cell["status"] == "ok" and cell["fits"],
              f"dry run of {LAUNCH_DRYRUN}: status {cell['status']}, fits "
              f"{cell.get('fits')}")
    finally:
        for proc, log in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    mflops = model_flops_for(get_config(TRAIN_ARCH), "train", TRAIN_B,
                             TRAIN_S)
    step_s = rec["median_step_s_after_first"]
    emit({"phase": "launch", "card": card,
          "launcher": {"argv": " ".join(LAUNCH_ARGS),
                       "params": rec["params"], "losses": losses,
                       "step_s": rec["step_s"],
                       "median_step_s_after_first": step_s,
                       "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                       "peak_memory_gb": rec["peak_memory_bytes"] / 1e9,
                       "model_flops": mflops,
                       "mfu_bf16": mflops / step_s / H100_BF16_PEAK_FLOPS,
                       "direct_losses": direct,
                       "loss_rel_err": err, "limit": LAUNCH_LOSS_RTOL,
                       "doubled_lr_losses": doubled,
                       "doubled_lr_rel_err": err_doubled,
                       "direct_runs_s": t_direct,
                       "wall_s": rec["wall_s"]},
          "hpcc_suite": [{k: r[k] for k in ("benchmark", "backend",
                                            "metric", "error", "gate",
                                            "launches")} for r in rows],
          "launches_hpcc_suite": hpcc,
          "examples_ok": sorted(ran), "serve_lm_greedy_repeat": True,
          "dryrun": {k: cell[k] for k in (
              "arch", "shape", "mesh", "chips", "status", "fits",
              "flops_per_device", "hbm_bytes_per_device",
              "collective_wire_bytes", "peak_bytes_per_device",
              "state_bytes_per_device", "dominant", "useful_ratio",
              "compile_s", "links", "figures")},
          "gates": "ok", "seconds": time.perf_counter() - t0})
    return hpcc


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if argv[:1] == ["--phase-train"]:  # phase train's own process
        train_phase(torch, argv[1])
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # each phase's seconds, printed on a line of their own before the
    # kernels line
    seconds, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name], clock[0] = now - clock[0], now

    phase_build(smi)
    lap("build")
    from repro_torch.kernels import ops

    rows = phase_kernels(torch)
    lap("kernels")
    counts, per_fact, _ = phase_hpl(torch)
    lap("hpl")
    phase_lookahead(torch)
    lap("lookahead")
    launches = {k: counts[k] for k in ops.HPL_KERNELS}
    launches["transpose_add"] = phase_ptrans(torch)["transpose_add"]
    lap("ptrans")
    phase_beff(torch)
    lap("beff")
    stream_counts = phase_stream(torch)
    lap("stream")
    launches.update({k: stream_counts[k] for k in ops.STREAM_KERNELS})
    launches["matmul"] = phase_gemm(torch)["matmul"]
    lap("gemm")
    phase_cpu(torch)
    lap("cpu")
    launches["flash_attention"] = phase_serve(torch)["flash_attention"]
    lap("serve")
    launches["ring_add_step"], ring_all_ranks = phase_allreduce(torch)
    lap("allreduce")
    phase_gups(torch)
    lap("gups")
    phase_fft(torch)
    lap("fft")
    phase_a2a(torch)
    lap("a2a")
    phase_autotune(torch, rows)
    lap("autotune")
    phase_faults(torch)
    lap("faults")
    phase_moe(torch)
    lap("moe")
    phase_ssm(torch)
    lap("ssm")
    phase_vlm(torch)
    lap("vlm")
    phase_whisper(torch)
    lap("whisper")
    phase_engine(torch)
    lap("engine")
    phase_train(torch, smi)
    lap("train")
    dp_launches, dp_all_ranks = phase_dp(torch)
    lap("dp")
    launches["ring_add_step"] += dp_launches
    ring_all_ranks += dp_all_ranks
    whole_launches, whole_all_ranks = phase_whole(torch, smi)
    lap("whole")
    check(whole_launches > 0, "phase whole launched no ring_add_step")
    launches["ring_add_step"] += whole_launches
    ring_all_ranks += whole_all_ranks
    gspmd_flash = phase_gspmd(torch, smi)
    lap("gspmd")
    families_flash = phase_gspmd_families(torch, smi)
    lap("gspmd_families")
    serve_mesh_launches = phase_serve_mesh(torch, smi)
    lap("serve_mesh")
    hpcc_launches = phase_launch(torch, smi)
    lap("launch")

    check(set(launches) == set(rows) == set(SOURCES),
          f"kernels {sorted(rows)} vs launches {sorted(launches)}")
    kernels = []
    for name, r in rows.items():
        entry = dict(name=name, route="cuda", source=SOURCES[name],
                     replaces=REPLACES[name], launches=launches[name])
        if name in ops.HPL_KERNELS:
            entry["launches_per_factorization"] = per_fact[name]
        if name in ops.ALLREDUCE_KERNELS:
            entry["launches_all_ranks"] = ring_all_ranks
        if name == "flash_attention":
            # the tensor-parallel prefill of phase gspmd, per rank
            entry["launches_gspmd_prefill_per_rank"] = gspmd_flash
            # phase gspmd_families' legs, per rank
            entry["launches_gspmd_families_per_rank"] = families_flash
        # phase serve_mesh's decode and engine legs, per rank (asserted 0)
        entry["launches_serve_mesh_per_rank"] = serve_mesh_launches[name]
        # examples.hpcc_suite at its own sizes, one rank (phase launch)
        entry["launches_hpcc_suite"] = hpcc_launches[name]
        entry.update(r)
        entry["kernel_ms"] = r["ms"]
        kernels.append(entry)
    emit({"phase_seconds": seconds, "total": sum(seconds.values())})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
