#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (metalchat_tpu_torch) on one
NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases (any failure makes the script exit non-zero without a result line):

1. The card's name and power limit (``nvidia-smi``).
2. Build the host's native library (``metalchat_tpu_torch/native``: the
   mmap data plane and the BPE merge loop) with ``g++``, its seconds
   printed (a missing or failing compiler fails the phase), then every CUDA
   kernel from ``metalchat_tpu_torch/csrc`` (one ``nvcc`` per source, all
   at once) and print the build time, registers and spills (each instance
   of the redesigned kernels on a line).
3. Hold each kernel against its plain PyTorch version on the card, at the
   Llama-3.1-8B shapes of the main path, at the fixture's (hd=64) and at
   Gemma-3-1B's (hd=256, windows of 512 that drop positions; row 1 at its
   widths with the norm prologue at offset 1), and row 11 at qlora-1b's
   shapes with f32 scales (``QMM_QLORA_1B``):
   a8_matvec raw mode int32-exact; cache bytes exact; every other output
   elementwise within one bf16 rounding step of the plain version's (see
   ``RTOL``), the fused matvec with its norm prologue within 1e-2 abs; lengths
   at block edges, length 1, windows, and a zeroed cache whose output comes
   from the new row alone. The matvec at 1, 2, 3, 5, 8 and 16 rows of the
   8B widths (int8 at 1 and 8), with a8_quantize held to the plain
   prologue's codes, and at one row at edge widths (``A8_EDGE``: k not a
   multiple of the 64-byte step, out not a multiple of the 16-row tile,
   with and without the norm) in bf16 and f32. The serve path's shapes too: decode attention
   (write and read-only, bf16 and
   int8 caches) at 8 rows of per-row lengths up to 1024, flash over
   256-token chunks of 8 rows at per-row offsets. Decode lengths at the
   edges of the kernel's 32-position chunks (``SPLIT_CHUNK``), windows
   starting inside a chunk, a batch that leaves most chunks dead; flash over
   a ragged 137-token chunk from unaligned starts; each attention wrapper
   the matvec at 2 rows (fused: two launches; raw) and at one row, the
   paged kernel in both modes, the dequant matmul (split-K at 1 and 8 rows,
   tensor cores) and the merged FFN block at 1 and 2 rows called twice
   inside one CUDA graph, replayed twice: outputs equal bit for bit across replays
   (the decode merge's order is fixed and its arrival counters reset) and
   within the limit of the plain version (raw exact).
   The paged kernel (both modes) at the 8B serving shape (8 rows, pages of
   256, 4 pages a row, 32 + 1 pages) and the fixture's (pages of 16), page
   tables shuffled with one free row at the sentinel: outputs of the rows
   whose write page is live within ``RTOL``, pages and scales exact except
   the shared garbage page; also pages of 8 and 48 at the 8B widths and of
   4 at the fixture's, where the kernel's chunks of 32 positions cross
   pages, lengths at the chunk edges. The dequant matmul (row 11) at the 8b-int4 and
   1b-int8 shapes, 1, 8 and 32 rows, within ``RTOL``; the merged FFN block
   (row 10) at 8B widths, 1, 2, 5, 8 and 16 rows, phase by phase (see
   ``ACT_SLOPE``). Row 1 with a device index (Mixtral's routed experts) at
   Mixtral-8x7B's expert widths and at a tp-2 rank's (``A8_MIXTRAL_TP2``:
   w1/w3 out 7168, w2 in 7168, phase tp-moe's local stacks) over a
   flattened stack of 256 entries, 1 and 2 rows, entries 0, 7, 128 and 255
   (past 2^31 bytes), within ``RTOL``, and
   one call in a CUDA graph replayed before and after its index is
   rewritten on the card: the output follows the index. Rows 6 and 7 (the
   one-layer read-only forms) at the 8B shapes, 1 and 8 rows. Rows 1, 3,
   4, 5 and 8 at GPT-2 XL's shapes (``gpt2_kernel_checks``: 25 heads of 64
   over 25 kv heads, lengths off the 32- and 64-position edges; row 1 at K
   1600 and 6400 and at the odd vocabulary, out 50257). Row 1 at the 8B's
   tensor-parallel local shapes over two ranks (``A8_8B_TP2``: wqkv 3072,
   wo K 2048, w13 14336, w2 K 7168, the lm_head's 64128 rows) at 1 and 8
   rows. Row 11 at phase tp-leaves' local shapes (``QMM_8B_INT4_TP2``,
   ``QMM_QLORA_1B_TP2``) at 1 and 8 rows, and the row-parallel ones in the
   f32-output mode within the f32 limit.
4. The trained fixture end to end, W4A8 + int8 KV, 3 requests through
   ``generate``: kernels on the card against the plain path on the CPU; the
   first 16 greedy tokens of each request must agree. fixture-int: the same
   for the fixture quantized weight-only (int4 and int8, group 32) and for
   W4A8 with ``ffn_block=True``, in bf16, and each decode step's logits fed
   the CPU's tokens within ``check_logits``'s limit. After every phase the
   split kernels' arrival counters must be back at zero.
5. The main path at full width: ``8b-w4a8`` (Llama-3.1-8B geometry, all 32
   layers, random int4 weights from a seeded ``torch.Generator``, int8 KV,
   context 1024), a 512-token prompt then 64 greedy decode steps through
   ``generate`` (one eager warm-up step, the capture of one step in a CUDA
   graph, 63 replays), every kernel's launches held exactly around that
   run (a replay counts the launches it holds); the ids and the cache
   equal, bit for bit, those of an eager loop of ``forward`` calls written
   here (``eager_generate``); decode tok/s of the graph route and the eager
   loop in turns, the capture time and 63 replays alone. Then
   ``torch.profiler`` over one prefill, 8 eager decode steps and 8 replays
   of the captured step (the device's busy share and device time by
   kernel). main-ffn-block: the same params with ``ffn_block=True`` (32
   ffn_block and 33 a8_matvec launches a step), the same checks, then the
   merged and unmerged routes in turns. main-int4: ``8b-int4`` (weight-only
   int4, group 32), 129 dequant-matmul launches a step, the same checks,
   and its profile. stream: ``generate_stream`` on the 8b-w4a8 params, a
   dense bf16 cache of 1024, 4 sink positions, a 960-token prompt and 128
   tokens, so the cache rolls in place and the graph replays on: ids equal
   to ``eager_stream``'s, launches exact; the fixture's stream (a 56-position
   cache that rolls after 7 tokens) card against CPU, the first 16 ids
   identical.
   gemma: Gemma-3-1B W8A8 (``Gemma3Config.gemma3_1b``, all 26 layers, hd
   256, window 512 on 5 layers of 6, random int8 weights, int8 KV, context
   1024) through ``generate``: a 640-token prompt, 64 greedy tokens, 105
   a8_matvec and 26 decode_attention_update launches a step and 26 flash a
   prefill, the graph route equal to the eager loop, its profile, and the
   window check (logits differ against windows of 1024 and none).
   gemma-fixture: Gemma-3-1B's widths cut to 2 layers, window 64, one
   sliding and one global layer, bf16: card against the CPU's plain path,
   each of 16 steps' logits within ``check_logits``'s limit.
   mixtral-fixture: Mixtral-8x7B's widths cut to 1 layer and to 2, W4A8
   experts, int8 KV, bf16, a 96-token prompt (the prefill's MoE dispatch)
   and 4 steps at 1 and 2 rows: card against the CPU's plain path, both
   sides' routing recorded, each step's logits within ``check_logits``'s
   limit of the CPU's, or, where the card routed a token to other experts
   at a router near tie (a gap of at most ``ROUTER_TIE_GAP``), of the CPU's
   run given the card's routing, each such step printed with its router
   gap (``check_routed_logits``); greedy ids equal
   or parted only after such a step, where the CPU given the card's routing
   picks the card's ids; launches exact; the smallest gap between the 2nd
   and 3rd router probability printed.
   mixtral: Mixtral-8x7B W4A8 (``MixtralConfig.mixtral_8x7b``, all 32
   layers, random experts built here, int8 KV, context 1024) through
   ``generate``: a 512-token prompt, 64 greedy tokens, per step 65 host-index
   matvec calls, 192 indexed expert calls and 32 decode_attention_update
   launches, 32 flash a prefill; the graph route equal to the eager loop;
   its profile; the HBM share against the routed bytes a token.
   scan: ``forward(fast_decode=False)`` (the JAX package's scan route) on
   the 8b-w4a8 params, 16 one-token steps after the main prompt on an int8
   dense, a bf16 dense and a paged cache: logits within ``check_logits`` of
   the fast route, one row-6 or row-7 launch a layer and nothing else.
   speculative: ``speculative_generate`` with the 8b-w4a8 params as the
   target and Llama-3.2-1B's widths (random bf16 weights, W8A8 unfused) as
   the draft, dense bf16 caches, the main prompt, 64 tokens at n_draft 4:
   three captured steps and one host read a round, launches exact a round
   (465 row 1, 32 row 5, 48 flash for the prefills); ids and both caches
   equal to the JAX loop's (``_windows=False``) bit for bit; ids equal to
   ``generate``'s but at a parting that ``near_tie`` explains; decode tok/s
   at ``_force_accept`` 3 and 0 against ``generate`` in turns; each
   captured step's device ms; ``measure_step_ratio`` and
   ``breakeven_accept_rate``. speculative-fixture: the fixture's W4A8
   target and W8A8 draft in f32, the tie-free prompts, card against CPU:
   ids and stats equal, ids equal to the greedy ``generate``'s.
   gpt2: GPT-2 XL W8A8 (openai-community/gpt2-xl's widths, all 48 layers,
   random int8 weights and non-zero biases, layernorm terms and positions
   drawn on the card by ``make_gpt2_params``, wqkv fused, a dense bf16
   lm_head, int8 KV, context 1024) through ``generate``: a 512-token prompt,
   64 greedy tokens, 192 a8_matvec and 48 decode_attention_update launches
   a step and 48 flash a prefill, the graph route equal to the eager loop
   and both timed in turns, its profile; then ``generate`` on its default
   dense bf16 cache (48 row-5 launches a step), ids equal to the eager
   loop's. gpt2-fixture: GPT-2 cut to 2 layers (hidden 256, 4 heads of 64,
   vocab 512) in f32, W8A8 bf16, and weight-only int8/int4 group 32 with
   row-quantized embeddings: card against the CPU's plain path, each
   step's logits within ``check_logits``'s limit, ids equal or parted at a
   near tie, launches exact. ppl: ``quant.ppl.perplexity_delta`` of the
   trained fixture in bf16 against W8A8, W4A8, int4 g32 with and without
   ``clip_search`` and int8 g32 with ``quantize_embed``, and W4A8 with
   ``clip_search``, AWQ (α ``PPL_AWQ_ALPHA``), GPTQ, GPTQ with two scale
   refits and AWQ + GPTQ (each calibrated tree quantized on the card and on
   the CPU from the same bf16 weights, its codes card against CPU within
   ``GPTQ_TOLERANCE``'s share, and for plain GPTQ where they part:
   ``gptq_cause``), card against CPU within ``PPL_RTOL``, the table printed.
   quality (after ppl, ``phase_quality``): the port's quality gate
   (``tools/quality_gate.py``) on the card at ``--batches 4 --batch 4
   --seq 128``, phase ppl's eval batches and calibration rows: the AWQ α
   search, three GPTQ trees, twelve schemes, the long-context tiebreak,
   ``headline_int8kv``; every scheme's perplexity within ``PPL_RTOL`` of
   the CPU's (phase ppl's number where it scores the scheme, else computed
   on the CPU here); α, the headline and the record printed.
   qlora-1b (run after chat, before the larger models load): a
   reference-dialect QLoRA checkpoint at Llama-3.2-1B's widths
   (``write_reference_qlora``: int8 g32 with f32 scales, rank-16 adaptors,
   the head tied to the embedding, 1.41 GB in a temporary directory) loaded
   onto the card by ``load_reference_qlora``, then ``generate`` as the main
   phase drives it (113 quant_matmul and 16 decode_attention_update
   launches a step, 16 flash a prefill, the graph route equal to the eager
   loop), its profile, and a native round trip (``export_quantized``,
   ``save_safetensors``, ``load_quantized``): every exported tensor equal,
   16 greedy ids and every step's logits bit for bit. train (after
   qlora-1b, ``phase_train``): QLoRA fine-tuning of that tree, its rank-16
   adaptors trainable, 8 Adam steps with remat on one batch of 4 x 512
   tokens from a generator of its own: the loss descends, no kernel is
   launched, the frozen bytes are unchanged; the first step against the CPU
   port on a 2-layer cut (``TRAIN_CHECK``); each step's wall ms, the peak
   memory and one profiled step's device split; the trained tree exported,
   reloaded and served by ``generate`` (ids equal to the in-memory tree's,
   rows 11, 3 and 4 launched as qlora-1b counts them); then the fixture
   fine-tuned whole in f32, card against CPU, and remat against none on the
   card; then ``tools/train_fixture.py`` at its 10m widths (batch 32 x 512)
   for the first 20 steps of its schedule (``train_fixture_tool``): the
   loss descends, no launch, the fixture it writes reloads through the
   native mapping bit for bit and ``generate`` from it gives the CPU's 16
   ids. tp (after chat, ``phase_tp``): tensor-parallel decode and serving,
   two ranks (``tp_rank``, processes started with ``spawn``) on the one card
   over gloo (NCCL refuses two ranks on one device), a ``file://``
   rendezvous, the kernels loaded from phase build's libraries. Each rank
   makes the seeded 8b-w4a8 tree (its digest equal on both ranks, one
   all_reduce, and equal to main's), shards it through ``MultiHostEngine``
   and frees the whole one, then a 512-token prefill and 32 greedy steps
   through ``tp_decode_forward_fn`` (eager: collectives between the kernels)
   held against a one-process run of main's params: the prefill's logits
   within ``check_logits``'s limit (bit-equality printed), layer 0's K/V
   codes after the first step bit-equal, the first step's logits within
   relative L2 5e-2, both ranks' ids (and ``generate``'s) equal; per rank
   and step 129 row-1 and 32 row-3 launches, 32 flash a prefill, nothing
   else, no capture. Then ``MultiHostEngine.run`` (paged, 8 requests of
   48-640 tokens, 48 greedy tokens each, 8 slots, chunks of 256): every
   stream finished and equal on both ranks, row-8 and row-1 launches exact.
   Its times are labelled "2 ranks over gloo on one card": functional
   numbers, not a tensor-parallel speed figure. Last, ``quality_tp_check``:
   ``tools/quality_tp.py`` at batch 4 x 128 (its own two gloo ranks): the
   one-process decode-path perplexity within ``PPL_RTOL`` of the CPU's, the
   tp-2 change printed. multihost (after tp,
   ``phase_multihost``): ``MultiHostServer`` on ``make_hybrid_mesh(dcn_dp=2,
   tp=2)``, four ranks (``multihost_rank``) on the one card over gloo, each
   making the 8b-w4a8 tree (digest equal to main's) that the server shards:
   requests of 116, 116 and 244 tokens in two rounds, 12 greedy tokens each
   on the sharded layer route, rank 0's ids equal, request by request, to a
   one-process loop of ``forward(fast_decode=False)``; per rank 32 flash a
   round and 32 row-6 launches a step; then ``MultiHostEngine`` on the same
   mesh and tree (an int8 cache of 4 slots, 2 a dp row, the
   tensor-parallel decode): streams equal on every rank, rank 0's ids equal
   to the one-process engine's or parted at a near tie, each prompt window
   run only on the dp row that owns its slots, launches exact per rank.
   tp-leaves (after tp-moe, ``phase_tp_leaves``): the sharded layer route
   on two ranks (``leaves_rank``) for the trees the tensor-parallel decode
   refuses: 8b-int4 (group-wise int4, fused; row 11 at the tp-local
   shapes, the row-parallel leaves in its f32-output mode), qlora-1b (int8
   bases with LoRA adaptors, from a reference file the phase writes) and
   GPT-2 large (W8A8, non-zero biases, an odd vocabulary); a 128-token
   prompt and 8 greedy tokens each, held against one process's
   ``forward(fast_decode=False)``: the prefill's last logits within
   ``check_logits``' limit, ids equal or parted at a near tie, launches
   exact per rank. tp-moe (``phase_tp_moe``):
   Mixtral-8x7B's widths cut to 8 layers, W4A8, int8 KV, two ranks
   (``moe_tp_rank``): (a) tp 2, MoE on the tensor-parallel decode (each
   routed expert through row 1's indexed entry at F/tp): the 512-token
   prefill within ``check_logits``' limit of one process's, layer 0's K/V
   bit-equal, the first step within relative L2 5e-2, ids equal on both
   ranks, launches exact (17 row 1, 48 indexed, 8 row 3 a step); (b) ep 2,
   the sharded layer route the engine picks for an ep mesh: the prefill
   within the limit of one process's layer route, layer 0's K/V bit-equal,
   ids equal on both ranks and to a one-process ``forward(fast_decode=
   False)`` loop or parted at a near tie, launches exact (8 flash a
   prefill, 8 row 6 a step, no row 1). gptq-1b: random dense
   bf16 weights at the same widths, the first ``GPTQ_LAYERS`` (4) of 16
   layers, ``gptq_quantize_params`` (W4A8, AWQ α
   ``GPTQ_AWQ_ALPHA``, two refits) on 8 x 512 calibration tokens, no
   factorization fallback, the AWQ fold's layer 0 byte for byte against the
   CPU's, layer 0's wk, wo, w1 and w2 codes (``GPTQ_COMPARE`` columns)
   against the CPU port within ``GPTQ_TOLERANCE``, the
   native round trip, and the reloaded tree fused through ``generate`` (32
   a8_matvec launches a step).
6. serve-fixture: the fixture through ``ContinuousBatchingEngine`` (6 greedy
   requests, 3 slots, chunks of 32, bursts of 4, f32 activations) in paged
   (pages of 16), dense int8 and dense activation-dtype mode, on the card
   and on the CPU plain path: the first 16 tokens of each request agree
   card vs CPU, and paged vs dense int8 on the card. On the card the engine
   replays a captured decode step (one CUDA graph per sampling branch); its
   ids, every cache tensor and its launch counts equal, bit for bit, those
   of ``eager_burst_engine`` (the burst as a loop of eager ``forward``
   calls). A mixed-sampler run (greedy rows beside top-k + top-p and
   temperature-only rows, all three branches captured): greedy rows equal
   to the eager engine's, every drawn id of the captured steps in its row's
   kept set (``check_kept``), two runs under one seed identical and another
   seed different. Each engine prints its captures, capture ms and graph
   pool bytes.
7. serve: ``8b-w4a8`` behind ``ContinuousBatchingEngine`` with the workload
   of ``bench.py --mode serve`` (24 requests at once, prompts of 48-640
   tokens, 96 greedy tokens each, 8 slots, bursts of 32, chunks of 256),
   paged (pages of 256) then dense int8: the graph route and the eager
   burst loop in turns (graph, eager, graph), each engine after a
   2-request warm-up: tok/s, TTFT and service TTFT p50/p99, the share of
   the full-slot decode roofline, every turn's launch counts held exactly
   to its engine's counters and prompt-chunk shapes (a8_quantize once per
   fused matvec call, at every row count), every turn's ids equal; the
   graph engine's wall by dispatch kind over one more run, each step
   synchronized; then ``torch.profiler`` over one paged decode dispatch (8
   steps) with all 8 slots decoding, on each route. Each serve phase runs
   its generate phase's model cut to its first ``SERVE_LAYERS`` layers
   (views of the stacks; widths, workload and turns unchanged), which
   keeps the script inside its time limit.
   serve-gemma: the gemma phase's model behind the engine with the same
   workload, all 24 requests, paged only, the same checks; serve-mixtral
   likewise for the mixtral phase's model (its 8-row step dense over
   experts: every expert at host indices); serve-gpt2 for the gpt2 phase's
   model (paged, pages of 256, turns graph, eager, graph: row 8 at 25
   heads, padded prompt chunks near the end of the position table).
8. http: the fixture behind ``InferenceServer`` on 127.0.0.1 (paged, on the
   card): a blocking completion, its SSE stream (same text), a chat
   completion, ``/health`` and ``/metrics``.
   chat (after stream): the chat ``Interpreter`` on the 8b-w4a8 params
   with a 128,000-rank Llama-3-layout tokenizer written here, greedy, a
   dense bf16 cache of 1024 positions and 4 sinks: a system and a user
   message (about 600 tokens) and a reply of up to 64 tokens, then a user
   message of about 300 tokens prefilled by flash at the session's position
   and a reply of up to 128 that rolls the cache. One captured decode step
   for the session; ids, pos and cache equal ``eager_chat``'s bit for bit;
   launches exact; each turn's TTFT and tok/s. cli-fixture: the CLI on the
   trained fixture in a temporary home: ``model pull``; ``serve`` of
   tests/test_fixture_e2e.py's prompt (first 16 ids against the library
   path on the CPU, printed beside its GOLDEN); ``prompt --quantize int4``
   (row 11); ``prompt --draft`` with the checkout as its own draft (its reply the
   greedy reply but at a ``near_tie`` parting); ``checkout`` in a process
   of its own with two lines on stdin.
   cli-1b: a checkout at Llama-3.2-1B's published widths written to disk
   (random bf16 weights, 2.47 GB), ``model pull``, ``prompt --quantize
   w8a8``: load and quantize time and its parts (``load_split``: mapping
   and header, host reads and stacking, upload, quantize), tokenize time,
   TTFT, tok/s, launches exact; the checkout opened through the native
   mapping and the message encoded through the native merge loop, its ids
   equal to the Python merge's; the checkout is deleted afterwards.
9. Each kernel timed with CUDA events at its path's shapes beside its bound,
   its plain version and one PyTorch library call as a yardstick: timing at
   the generate path's shapes (and row 3 at lengths 64 and 1024, row 4 at
   hd=64, kernel and yardstick only), timing-serve at the serve path's (8 rows;
   rows 1-2 per matrix with a8_quantize alone, and their step at 2 and 16
   rows), timing-ffn (row 10 beside the unmerged route, 1 and 8 rows) and
   timing-int4 (row 11 at 1 and 8 rows, per matrix), timing-gemma (rows
   3, 4, 5, 8 and 9 at hd 256, each layer with its window) and
   timing-mixtral (row 1 indexed: a batch-1 Mixtral step's 192 expert calls;
   rows 6 and 7: a scan-route step of 32 one-layer calls), timing-gpt2
   (rows 1 and 3 at GPT-2 XL's decode shapes: a step's 192 matvec calls,
   each with its a8_quantize alone, and 48 attention calls at length 576),
   timing-qlora (row 11 at qlora-1b's decode step: 113 calls, f32 scales).

The last lines are the kernel table as one JSON object (rows 1-11 of the
JAX package's TPU kernels), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
import traceback

# Kernel vs plain version, elementwise: |got - ref| <= RTOL*|ref| + ATOL_OF_MAX*max|ref|.
# Both compute in f32 and differ only in summation order (and expf), so in
# bf16 they round to the same or a neighbouring value: one step is at most
# 2**-7 of the value. The limit scales with the data, so an error of one
# cache row in a long average (a missing new row, an edge off by one) fails.
RTOL = {"bfloat16": 2 ** -7, "float32": 1e-4}
ATOL_OF_MAX = 1e-4
# The fused matvec with its norm prologue: the f32 statistics may reduce in
# another order and move one int8 code by a quantum, a change far below 1e-2
# at these scales (the CPU tests hold the codes themselves).
MAX_ABS_ERR = 1e-2
# The merged FFN block (row 10) is held phase by phase through its own
# scratch (x2, h), so that every phase reads the kernel's own input. Phases A
# (x2 = x + wo(attn)) and C (out = x2 + w2(h)) then compute the plain
# version's int8 codes exactly and meet the one-step limit above. In phase B
# the kernel's f32 norm statistics (block order, 1/sqrtf) and expf may differ
# from the plain version's by an ulp, which can move an int8 code of the
# normed x2 by a quantum at a rounding boundary. The check reads the codes
# the kernel multiplied (`ffn_norm_codes`) and bounds phase B by those that
# moved: each moves gate[j] by sx_n * s_gate[j] * |w[j, i]| (its own weight
# code, -128 included; up likewise), so h[j] moves by at most
# ACT_SLOPE*|up|*dg + |act(gate)|*du + ACT_SLOPE*dg*du with dg, du summed
# over the moved codes: phase B's limit adds that to the one-step limit. At
# most FFN_MOVED_CODES codes a row may move, by one quantum each. A code of
# h that moves in phase B moves in both versions of phase C alike, since
# phase C starts from the kernel's h.
ACT_SLOPE = 1.13  # sup |act'|: silu 1.0998, gelu_tanh 1.1289
FFN_MOVED_CODES = 4  # of a row's 4096 normed values; one draw on the card moved 2
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # H100 SXM
# The kernels `generate` runs with an int8 dense cache.
GENERATE_KERNELS = ("a8_matvec", "decode_attention_update", "flash_attention")
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense, 700 W


def hbm_rate(name: str) -> float:
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM rate recorded for {name!r}: add the card's "
                         "rate to HBM_BYTES_PER_S")
    return HBM_BYTES_PER_S[name]


def bound(nbytes: float, ops: float, op_type: str, rate: float):
    """Least time (ms) for the work, and whether bytes or operations set it."""
    t_bytes = nbytes / rate
    t_ops = ops / PEAK_OPS[op_type]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.err = {"a8_matvec": 0.0, "a8_matvec_indexed": 0.0, "a8_quantize": 0.0,
                    "decode_attention_update": 0.0, "decode_attention": 0.0,
                    "decode_attention_layer": 0.0, "flash_attention": 0.0,
                    "paged_decode_attention_update": 0.0, "paged_decode_attention": 0.0,
                    "paged_decode_attention_layer": 0.0, "quant_matmul": 0.0,
                    "ffn_block": 0.0}
        self.share = dict.fromkeys(self.err, 0.0)  # worst error / its limit
        self.tok_s = {}  # decode tok/s by run
        self.a8_library = {}  # torch._int_mm at M=17 per matvec shape (phase timing)

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            self.counters_at_rest(name)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
            return out
        except Exception:  # noqa: BLE001 — each phase reports and the run fails
            self.failures.append(name)
            print(f"[{name}] FAILED", flush=True)
            traceback.print_exc()
            return None

    def expect(self, cond: bool, what: str):
        if not cond:
            raise AssertionError(what)

    def close(self, kernel: str, got, want, what: str, loose: bool = False, extra=None):
        """Elementwise within the limit; ``extra`` (a tensor of the output's
        shape) widens it where a stated cause may move a value further."""
        dtype = str(got.dtype).removeprefix("torch.")
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        if loose:
            limit = self.torch.full_like(diff, MAX_ABS_ERR)
        else:
            limit = RTOL[dtype] * want.abs() + ATOL_OF_MAX * want.abs().max()
        if extra is not None:
            limit = limit + extra
        err = diff.max().item()
        share = (diff / limit).max().item()
        self.err[kernel] = max(self.err[kernel], err)
        self.share[kernel] = max(self.share[kernel], share)
        self.expect(bool(self.torch.isfinite(got).all()), f"{what}: non-finite output")
        self.expect(share <= 1.0, f"{what}: {int((diff > limit).sum())} elements "
                    f"beyond the limit (max abs err {err}, {share:.3g} of the limit, "
                    f"max |ref| {want.abs().max().item():.4g})")

    def counters_at_rest(self, what: str):
        """Every launch of a split kernel leaves the arrival counters it used
        at zero (``ops/_build.arrival_counters``); a count left behind would
        merge a later launch's partials early."""
        build = sys.modules.get("metalchat_tpu_torch.ops._build")
        for dev, buf in ({} if build is None else build._COUNTERS).items():
            n = int((buf != 0).sum())
            self.expect(n == 0, f"{what}: {n} arrival counters on {dev} not at zero")

    def exact(self, got, want, what: str):
        self.expect(bool(self.torch.equal(got, want)), f"{what}: not bit-exact")

    # -- timing ---------------------------------------------------------------

    def device_ms(self, fn, iters: int) -> float:
        """Device time per call: `iters` calls captured in a CUDA graph and
        replayed between CUDA events, so host launch cost is excluded."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(2):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        from metalchat_tpu_torch.ops._build import CountedGraph

        graph = CountedGraph()
        graph.capture(lambda: [fn(i) for i in range(iters)])
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)

    def eager_ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn(0)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(line.splitlines()[0] if line else "nvidia-smi: no card listed", flush=True)
    return line


def phase_build():
    from metalchat_tpu_torch.native import build as native_build
    from metalchat_tpu_torch.ops import _build

    # The host's native library (mmap data plane, BPE merge loop) with g++:
    # a missing or failing compiler fails the phase.
    built = native_build.library_path().exists()
    t0 = time.perf_counter()
    lib = native_build.build()
    print(f"build: native host library {lib.name} "
          + ("(already built)" if built else
             f"built by {native_build.CXX} {' '.join(native_build.CXX_FLAGS)} in "
             f"{time.perf_counter() - t0:.2f} s"), flush=True)
    seconds = _build.build_all()
    print(f"build: {seconds:.1f} s for {', '.join(_build.KERNELS)} (parallel nvcc)")
    for name in _build.KERNELS:
        log = _build.build_log(name).splitlines()
        regs = [int(l.split("Used ")[1].split(" ")[0]) for l in log if "Used " in l]
        spills = [l.strip() for l in log if "spill" in l and " 0 bytes spill stores" not in l]
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers; spills: {spills or 'none'}")
    # The redesigned kernels' instances, one line each.
    for name in ("a8_matvec", "flash_attention", "decode_attention", "quant_matmul",
                 "paged_attention", "ffn_block"):
        for fn, regs, spill in entry_functions(_build.build_log(name)):
            print(f"    {name} {fn}: {regs} registers, spill stores/loads {spill} bytes")
    return seconds


def entry_functions(log: str):
    """(demangled name, registers, "stores/loads") of each entry function in
    an ``nvcc -Xptxas -v`` log."""
    out, fn, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line and fn:
            words = line.replace(",", "").split()
            spill = f"{words[words.index('spill') - 2]}/{words[words.index('loads') - 3]}"
        elif "Used " in line and fn:
            out.append((fn, int(line.split("Used ")[1].split(" ")[0]), spill))
            fn, spill = None, "?"
    try:
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _, _ in out),
                               capture_output=True, text=True, timeout=30).stdout.split("\n")
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) >= len(out):
        out = [(n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0],
                r, sp) for n, (_, r, sp) in zip(names, out)]
    return out


# -- phase 3: kernels vs plain versions on the card ---------------------------

def check_quantize(sm: Smoke, x, nw, what: str, norm_offset: float = 0.0):
    """a8_quantize against the plain prologue: without the norm
    the codes, sx and corr are exact (same op order); with it the f32
    statistics may reduce in another order and move a code by one quantum
    at a rounding boundary (and the largest value by one step of x's dtype),
    so codes within 1, sx within ``RTOL`` of x's dtype, and corr exact against
    the kernel's own codes."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import a8_matvec as m

    kw = dict(norm_w=nw, norm_eps=None if nw is None else 1e-5, norm_offset=norm_offset)
    xq, sx, corr = m.quantize_rows(x, **kw)
    want_q, want_s, want_c = m.quantize_rows_plain(x, **kw)
    moved = (xq.int() - want_q.int()).abs().max().item()
    sm.err["a8_quantize"] = max(sm.err["a8_quantize"], moved)
    sm.share["a8_quantize"] = max(sm.share["a8_quantize"], moved)
    if nw is None:
        sm.exact(xq, want_q, what + " codes")
        sm.exact(sx, want_s, what + " sx")
        sm.exact(corr, want_c, what + " corr")
        return
    sm.expect(moved <= 1, f"{what}: a code moved by {moved} quanta")
    rtol = RTOL[str(x.dtype).removeprefix("torch.")]
    sm.expect(bool(((sx - want_s).abs() <= rtol * want_s.abs()).all()), f"{what}: sx")
    sm.exact(corr, 8 * xq[:, :x.shape[1] // 2].sum(dim=1, dtype=torch.int32), what + " corr")


def check_a8(sm: Smoke, shapes, batch: int, gen, dev, dtype=None, norm_offset: float = 0.0):
    """Raw mode int32-exact, fused within RTOL of the plain version (1e-2
    abs with the norm prologue, its weights ``norm_offset + w``); a8_quantize
    on its own too."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import a8_matvec as m

    for name, out_f, in_f, bits, with_norm in shapes:
        k = in_f // 2 if bits == 4 else in_f
        p = torch.randint(-128, 128, (2, out_f, k), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand((2, 1, out_f), generator=gen, device=dev) * 0.0015
             + 0.0005).to(torch.bfloat16)
        nw = (torch.rand((2, in_f), generator=gen, device=dev) + 0.5).to(dtype)
        x = torch.randn((batch, in_f), generator=gen, device=dev).to(dtype)
        xq = torch.randint(-127, 128, (batch, in_f), generator=gen, device=dev,
                           dtype=torch.int8)
        what = f"a8_matvec {name} {out_f}x{in_f} w{bits} B={batch} {dtype}"
        sm.exact(m.quant_matvec_stacked(xq, p, 1, bits=bits),
                 m.quant_matvec_stacked_plain(xq, p, 1, bits=bits), what + " raw")
        sm.close("a8_matvec", m.quant_matvec_stacked_fused(x, p, s, 1, bits=bits),
                 m.quant_matvec_stacked_fused_plain(x, p, s, 1, bits=bits),
                 what + " fused")
        if with_norm:
            kw = dict(bits=bits, norm_stack=nw, norm_eps=1e-5, norm_offset=norm_offset)
            sm.close("a8_matvec", m.quant_matvec_stacked_fused(x, p, s, 1, **kw),
                     m.quant_matvec_stacked_fused_plain(x, p, s, 1, **kw),
                     f"{what} fused+norm offset {norm_offset}", loose=True)
        check_quantize(sm, x, nw[1] if with_norm else None, what + " a8_quantize",
                       norm_offset)
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_decode(sm: Smoke, B, nh, nkv, T, hd, cases, gen, dev, dtype=None):
    """Each case is (lengths, window, cache): cache "random" holds random
    codes and scales, "zeros" holds zero codes and scales, so that the output
    is the new row's dequantized V times its softmax weight and a kernel that
    leaves the new row out returns 0."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import decode_attention as m

    for lengths, window, fill in cases:
        k = torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01
        vs = torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01
        if fill == "zeros":
            for t in (k, v, ks, vs):
                t.zero_()
        q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, nh, hd), (B, nkv, hd), (B, nkv, hd)))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ref = m.decode_attention_update_plain(q, kn, vn, k.clone(), v.clone(), ks.clone(),
                                              vs.clone(), 1, lens, scale=hd ** -0.5,
                                              window=window)
        got = m.decode_attention_update_quantized_stacked(
            q, kn, vn, k, v, ks, vs, 1, lens, scale=hd ** -0.5, window=window)
        what = (f"decode_attention_update hd={hd} lengths={lengths} window={window} "
                f"{fill} cache {dtype}")
        sm.close("decode_attention_update", got[0], ref[0], what)
        for a, b, nm in zip(got[1:], ref[1:], ("k", "v", "k_scale", "v_scale")):
            sm.exact(a, b, f"{what} cache {nm}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_decode_read(sm: Smoke, B, nh, nkv, T, hd, cases, gen, dev, dtype=None,
                      kv="act"):
    """The read-only mode over layer 1 of a 2-layer dense cache: in the
    activation dtype (``kv="act"``, random values) or int8 with scales.
    Each case is (lengths, window)."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import decode_attention as m

    for lengths, window in cases:
        if kv == "act":
            k, v = (torch.randn((2, B, nkv, T, hd), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            ks = vs = None
        else:
            k, v = (torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                                  dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01
                      for _ in range(2))
        q = torch.randn((B, nh, hd), generator=gen, device=dev).to(dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(scale=hd ** -0.5, window=window)
        if kv == "act":
            got = m.decode_attention_stacked(q, k, v, 1, lens, **kw)
        else:
            got = m.decode_attention_quantized_stacked(q, k, v, ks, vs, 1, lens, **kw)
        sm.close("decode_attention", got,
                 m.decode_attention_stacked_plain(q, k, v, ks, vs, 1, lens, **kw),
                 f"decode_attention hd={hd} {kv} cache lengths={lengths} window={window} "
                 f"{dtype}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_flash(sm: Smoke, B, S, nh, nkv, T, hd, cases, gen, dev, dtype=None):
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    for start, window in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, S, nh, hd), (B, nkv, T, hd), (B, nkv, T, hd)))
        sp = torch.tensor(start, dtype=torch.int32, device=dev) if isinstance(
            start, list) else start
        sm.close("flash_attention",
                 flash_attention(q, k, v, sp, scale=hd ** -0.5, window=window),
                 flash_attention_plain(q, k, v, sp, scale=hd ** -0.5, window=window),
                 f"flash_attention hd={hd} S={S} start={start} window={window} {dtype}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_graph_replay(sm: Smoke, B, nh, nkv, T, hd, gen, dev, dtype=None):
    """Two calls of each attention wrapper captured in one CUDA graph, the
    graph replayed twice. The second call can merge only if the first left
    the decode kernel's arrival counters at 0; its output must be equal bit
    for bit across the two replays (the merge order is fixed) and within
    the limit of the plain version. Rows at very different lengths, one in
    a window that starts inside a chunk; the paged kernel in both modes over
    pages of 16, its pool exact after the replays. The same for the matvec at B rows
    (wqkv's shape, int4): the fused route's two launches (a8_quantize, then
    the tensor-core matvec, whose inputs the wrapper allocates on every
    call) with the norm prologue, and raw mode, exact; the same at one row;
    the dequant matmul (row 11): the split-K natural
    route at 1 and 8 rows, whose last block merges the workspace, and the
    transposed route at B rows; and the merged FFN block (row 10, int4, F =
    3.5 H) at 1 and B rows, x2 and out held phase by phase through its
    scratch."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm
    from metalchat_tpu_torch.ops import quant_matmul as qm
    from metalchat_tpu_torch.ops._build import CountedGraph
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    lengths = [T - 1 - 17 * b for b in range(B)]
    lengths[-1] = SPLIT_CHUNK + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    window = 3 * SPLIT_CHUNK + 5
    k, v = (torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01 for _ in range(2))
    kc, vc = (torch.randn((2, B, nkv, T, hd), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, nh, hd), (B, nkv, hd), (B, nkv, hd)))
    S = min(256, T // 2)
    qf, kf, vf = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, S, nh, hd), (B, nkv, T, hd), (B, nkv, T, hd)))
    starts = torch.tensor([T - S - 3 * b for b in range(B)], dtype=torch.int32, device=dev)
    kw = dict(scale=hd ** -0.5)
    ref_cache = [t.clone() for t in (k, v, ks, vs)]
    in_f, out_f = nh * hd, (nh + 2 * nkv) * hd
    pw = torch.randint(-128, 128, (2, out_f, in_f // 2), generator=gen, device=dev,
                       dtype=torch.int8)
    sw = (torch.rand((2, 1, out_f), generator=gen, device=dev) * 0.0015 + 0.0005).to(
        torch.bfloat16)
    nw = (torch.rand((2, in_f), generator=gen, device=dev) + 0.5).to(dtype)
    xa = torch.randn((B, in_f), generator=gen, device=dev).to(dtype)
    xq = torch.randint(-127, 128, (B, in_f), generator=gen, device=dev, dtype=torch.int8)
    a8 = dict(bits=4, norm_stack=nw, norm_eps=1e-5)
    # Row 11: the non-transposed split-K route at 1 and 8 rows (wo's shape:
    # partials through the workspace, the last block of a strip merging
    # them) and the transposed tensor-core route, int4, group 32.
    qk = dict(bits=4, group_size=32)
    qn = torch.randint(-128, 128, (in_f // 2, in_f), generator=gen, device=dev,
                       dtype=torch.int8)
    sn = (torch.rand((in_f // 32, in_f), generator=gen, device=dev) * 0.01 + 0.001).to(
        torch.bfloat16)
    qt = torch.randint(-128, 128, (out_f, in_f // 2), generator=gen, device=dev,
                       dtype=torch.int8)
    st = (torch.rand((out_f, in_f // 32), generator=gen, device=dev) * 0.01 + 0.001).to(
        torch.bfloat16)
    xr = {r: torch.randn((r, in_f), generator=gen, device=dev).to(dtype) for r in (1, 8)}
    # Rows 8-9: the paged kernel over pages of 16 (chunks cross pages), the
    # same lengths and window; the pool is updated in place, and the second
    # call of a replay writes the same bytes as the first.
    psize, mp = 16, T // 16
    table = torch.randperm(B * mp, generator=gen, device=dev).to(torch.int32).reshape(B, mp)
    pool = [torch.randint(-127, 128, (2, nkv, B * mp + 1, psize, hd), generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2)]
    pool += [torch.rand((2, B * mp + 1, nkv, psize), generator=gen, device=dev) * 0.01
             for _ in range(2)]
    ref_pool = [t.clone() for t in pool]
    cases = {  # name: (call, plain output, comparison)
        "decode_attention_update": (
            lambda: dm.decode_attention_update_quantized_stacked(
                q, kn, vn, k, v, ks, vs, 1, lens, window=window, **kw)[0],
            dm.decode_attention_update_plain(q, kn, vn, *ref_cache, 1, lens, window=window,
                                             **kw)[0], "close"),
        "decode_attention": (
            lambda: dm.decode_attention_stacked(q, kc, vc, 1, lens, **kw),
            dm.decode_attention_stacked_plain(q, kc, vc, None, None, 1, lens, **kw), "close"),
        "flash_attention": (
            lambda: flash_attention(qf, kf, vf, starts, **kw),
            flash_attention_plain(qf, kf, vf, starts, **kw), "close"),
        "a8_matvec": (
            lambda: am.quant_matvec_stacked_fused(xa, pw, sw, 1, **a8),
            am.quant_matvec_stacked_fused_plain(xa, pw, sw, 1, **a8), "loose"),
        "a8_matvec_raw": (
            lambda: am.quant_matvec_stacked(xq, pw, 1, bits=4),
            am.quant_matvec_stacked_plain(xq, pw, 1, bits=4), "exact"),
        "a8_matvec one row": (
            lambda: am.quant_matvec_stacked_fused(xa[:1], pw, sw, 1, **a8),
            am.quant_matvec_stacked_fused_plain(xa[:1], pw, sw, 1, **a8), "loose"),
        "a8_matvec_raw one row": (
            lambda: am.quant_matvec_stacked(xq[:1], pw, 1, bits=4),
            am.quant_matvec_stacked_plain(xq[:1], pw, 1, bits=4), "exact"),
        "quant_matmul natural 1 row": (
            lambda: qm.dequant_matmul(xr[1], qn, sn, transposed=False, **qk),
            qm.dequant_matmul_plain(xr[1], qn, sn, transposed=False, **qk), "close"),
        "quant_matmul natural 8 rows": (
            lambda: qm.dequant_matmul(xr[8], qn, sn, transposed=False, **qk),
            qm.dequant_matmul_plain(xr[8], qn, sn, transposed=False, **qk), "close"),
        "quant_matmul transposed": (
            lambda: qm.dequant_matmul(xa, qt, st, transposed=True, **qk),
            qm.dequant_matmul_plain(xa, qt, st, transposed=True, **qk), "close"),
        "paged_decode_attention_update": (
            lambda: pm.paged_decode_attention_update_stacked(
                q, kn, vn, *pool, table, lens, 1, window=window, **kw)[0],
            pm.paged_decode_attention_update_plain(
                q, kn, vn, *ref_pool, table, lens, 1, window=window, **kw)[0], "close"),
        "paged_decode_attention": (
            lambda: pm.paged_decode_attention_stacked(q, *pool, table, lens, 0, **kw),
            pm.paged_decode_attention_plain(q, *ref_pool, table, lens, 0, **kw), "close"),
    }
    def replayed(kernel):
        """The second call's output after each of two replays of a graph of
        two calls."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = CountedGraph()
        out = graph.capture(lambda: (kernel(), kernel())[1])
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(out.clone())
        return replays

    for name, (kernel, want, compare) in cases.items():
        replays = replayed(kernel)
        what = f"{name} lengths={lengths} B={B} second call in a CUDA graph"
        sm.exact(replays[0], replays[1], f"{what}: two replays")
        if compare == "exact":
            sm.exact(replays[1], want, what)
        else:
            sm.close(name.split(" ")[0], replays[1], want, what, loose=compare == "loose")
    from metalchat_tpu_torch.ops import ffn_block as fm

    fw = ffn_weights(torch, 2, in_f, 7 * in_f // 2, 4, gen, dev, dtype)
    for rows in (1, B):
        attn_f, x_f = (torch.randn((rows, in_f), generator=gen, device=dev).to(dtype)
                       for _ in range(2))
        scratch = {}
        replays = replayed(lambda: fm.ffn_block_stacked(
            attn_f, x_f, *fw.values(), 1, bits=4, act="silu", eps=1e-5, scratch=scratch))
        what = f"ffn_block H={in_f} B={rows} second call in a CUDA graph"
        sm.exact(replays[0], replays[1], f"{what}: two replays")
        x2, h = scratch["x2"], scratch["h"]
        sm.close("ffn_block", x2, fm.wo_stage(attn_f, x_f, fw["wo_q"][1], fw["wo_s"][1], bits=4),
                 what + " phase A (x2)")
        sm.close("ffn_block", replays[1], fm.w2_stage(h, x2, fw["w2_q"][1], fw["w2_s"][1],
                                                      bits=4)[0], what + " phase C (out)")
    for a, b, nm in zip((k, v, ks, vs), ref_cache, ("k", "v", "k_scale", "v_scale")):
        sm.exact(a, b, f"decode_attention_update in a CUDA graph: cache {nm}")
    for a, b, nm in zip(pool, ref_pool, ("k", "v", "k_scale", "v_scale")):
        sm.exact(a, b, f"paged_decode_attention_update in a CUDA graph: pool {nm}")


def indexed_stack(torch, out_f, in_f, entries, n, gen, dev):
    """A flattened int4 expert stack ``[n, out, in/2]``, random bytes in the
    ``entries`` and left uninitialised elsewhere (nothing reads them), and
    bf16 scales ``[n, 1, out]``."""
    p = torch.empty((n, out_f, in_f // 2), dtype=torch.int8, device=dev)
    for e in entries:
        p[e] = torch.randint(-128, 128, (out_f, in_f // 2), generator=gen, device=dev,
                             dtype=torch.int8)
    s = (torch.rand((n, 1, out_f), generator=gen, device=dev) * 0.0015 + 0.0005).to(
        torch.bfloat16)
    return p, s


def check_a8_indexed(sm: Smoke, shapes, rows, entries, n, gen, dev):
    """Row 1 with the stack entry in a 0-d int32 tensor on the card, read by
    the kernel: every entry within RTOL of the plain version on the same
    index. Then one call captured in a CUDA graph and replayed, the index
    rewritten on the card (``fill_``) and the graph replayed again: the
    output follows the new entry, as a routed expert needs."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import a8_matvec as m
    from metalchat_tpu_torch.ops._build import CountedGraph

    for name, out_f, in_f in shapes:
        p, s = indexed_stack(torch, out_f, in_f, entries, n, gen, dev)
        for b in rows:
            x = torch.randn((b, in_f), generator=gen, device=dev).to(torch.bfloat16)
            what = f"a8_matvec indexed {name} {out_f}x{in_f} w4 B={b}"
            want = {}
            for e in entries:
                index = torch.tensor(e, dtype=torch.int32, device=dev)
                want[e] = m.quant_matvec_stacked_fused_plain(x, p, s, index, bits=4)
                sm.close("a8_matvec_indexed", m.quant_matvec_stacked_fused(x, p, s, index, bits=4),
                         want[e], f"{what} entry {e} (byte {e * out_f * in_f // 2})")
            first, last = entries[0], entries[-1]
            index = torch.tensor(first, dtype=torch.int32, device=dev)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                m.quant_matvec_stacked_fused(x, p, s, index, bits=4)
            torch.cuda.current_stream().wait_stream(side)
            graph = CountedGraph()
            out = graph.capture(lambda: m.quant_matvec_stacked_fused(x, p, s, index, bits=4))
            graph.replay()
            got_first = out.clone()
            index.fill_(last)
            graph.replay()
            sm.close("a8_matvec_indexed", got_first, want[first],
                     f"{what} in a CUDA graph at entry {first}")
            sm.close("a8_matvec_indexed", out, want[last],
                     f"{what} in a CUDA graph, the index rewritten to {last}")
            sm.expect(not torch.equal(out, got_first),
                      f"{what}: the replay did not follow the rewritten index")
        del p, s
        torch.cuda.synchronize()


def check_one_layer(sm: Smoke, B, nh, nkv, T, hd, cases, psize, gen, dev, dtype=None):
    """Rows 6 and 7, the one-layer read-only forms (the JAX package's scan
    route at one token): ``decode_attention`` over a cache in the activation
    dtype, ``decode_attention_quantized`` over an int8 one and
    ``paged_decode_attention`` over pages of ``psize`` (the table built as
    the engine builds it, the last row free), each against its plain
    version. Each case is (lengths, window)."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm

    kw = dict(scale=hd ** -0.5)
    mp = T // psize
    rows = max(B, 2)  # the table's last row is free: one row gets a free row beside it
    n_pages = rows * mp
    for lengths, window in cases:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn((B, nh, hd), generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn((B, nkv, T, hd), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        k8, v8 = (torch.randint(-127, 128, (B, nkv, T, hd), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, nkv, T), generator=gen, device=dev) * 0.01 for _ in range(2))
        what = f"hd={hd} B={B} lengths={lengths} window={window} {dtype}"
        sm.close("decode_attention_layer",
                 dm.decode_attention(q, kc, vc, lens, window=window, **kw),
                 dm.decode_attention_stacked_plain(q, kc[None], vc[None], None, None, 0, lens,
                                                   window=window, **kw),
                 f"decode_attention one layer {what}")
        sm.close("decode_attention_layer",
                 dm.decode_attention_quantized(q, k8, v8, ks, vs, lens, window=window, **kw),
                 dm.decode_attention_stacked_plain(q, k8[None], v8[None], ks[None], vs[None], 0,
                                                   lens, window=window, **kw),
                 f"decode_attention_quantized one layer {what}")
        table = paged_table(torch, rows, mp, psize, n_pages,
                            lengths + [1] * (rows - B), gen, dev)[:B]
        pool = [torch.randint(-127, 128, (nkv, n_pages + 1, psize, hd), generator=gen,
                              device=dev, dtype=torch.int8) for _ in range(2)]
        pool += [torch.rand((n_pages + 1, nkv, psize), generator=gen, device=dev) * 0.01
                 for _ in range(2)]
        sm.close("paged_decode_attention_layer",
                 pm.paged_decode_attention(q, *pool, table, lens, window=window, **kw),
                 pm.paged_decode_attention_plain(q, *(t[None] for t in pool), table, lens, 0,
                                                 window=window, **kw),
                 f"paged_decode_attention one layer psize={psize} {what}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def paged_table(torch, B, mp, psize, n_pages, lengths, gen, dev):
    """A page table as the engine builds it: each live row owns the pages
    its length needs, drawn from a shuffled pool so that they are not
    contiguous; the rest, and the whole last (free) row, at the sentinel."""
    order = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, mp), n_pages, dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths[:-1]):
        need = -(-n // psize)
        table[b, :need] = order[b * mp:b * mp + need]
    return table


def check_paged(sm: Smoke, B, nh, nkv, hd, psize, mp, cases, gen, dev, dtype=None):
    """Both modes of the paged kernel against the plain version, on layer 1
    of a 2-layer pool of B·mp + 1 pages. Each case is (lengths, window); the
    last row is a free row at the sentinel with length 1. Outputs are held
    on the rows whose write page is live (rows that write the shared garbage
    page race there and get an undefined output), pages and scales exactly
    on every page but the garbage page."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import paged_attention as m

    n_pages = B * mp
    for lengths, window in cases:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        table = paged_table(torch, B, mp, psize, n_pages, lengths, gen, dev)
        pages = [torch.randint(-127, 128, (2, nkv, n_pages + 1, psize, hd), generator=gen,
                               device=dev, dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((2, n_pages + 1, nkv, psize), generator=gen, device=dev) * 0.01
                  for _ in range(2)]
        q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, nh, hd), (B, nkv, hd), (B, nkv, hd)))
        what = (f"paged hd={hd} psize={psize} mp={mp} lengths={lengths} window={window} "
                f"{dtype}")
        live = table[torch.arange(B, device=dev), (lens.long() - 1) // psize] != n_pages
        cache = [t.clone() for t in pages + scales]
        ref = m.paged_decode_attention_update_plain(
            q, kn, vn, *cache, table, lens, 1, scale=hd ** -0.5, window=window)
        got = m.paged_decode_attention_update_stacked(
            q, kn, vn, *pages, *scales, table, lens, 1, scale=hd ** -0.5, window=window)
        sm.close("paged_decode_attention_update", got[0][live], ref[0][live],
                 f"{what} update")
        for a, b, nm in zip(got[1:], ref[1:], ("k", "v", "k_scale", "v_scale")):
            live_pages = (slice(None), slice(None), slice(0, n_pages)) if a.ndim == 5 else (
                slice(None), slice(0, n_pages))
            sm.exact(a[live_pages], b[live_pages], f"{what} update {nm}")
        sm.close("paged_decode_attention",
                 m.paged_decode_attention_stacked(q, *pages, *scales, table, lens, 0,
                                                  scale=hd ** -0.5, window=window),
                 m.paged_decode_attention_plain(q, *pages, *scales, table, lens, 0,
                                                scale=hd ** -0.5, window=window),
                 f"{what} read-only")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_qmm(sm: Smoke, shapes, rows: int, gen, dev, dtype=None, scales_dtype=None,
              out_dtype=None):
    """The dequant-matmul kernel (row 11) against its plain version. Each
    shape is (name, out, in, bits, group, transposed); random packed bytes,
    positive scales in ``scales_dtype`` (bf16 by default), x in ``dtype``;
    ``out_dtype`` f32 is the row-parallel mode (the f32 sums not rounded to
    x's dtype), held to the f32 plain version within the f32 limit."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    scales_dtype = scales_dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import quant_matmul as m

    for name, out_f, in_f, bits, group, transposed in shapes:
        k = in_f // 2 if bits == 4 else in_f
        q = torch.randint(-128, 128, (out_f, k) if transposed else (k, out_f), generator=gen,
                          device=dev, dtype=torch.int8)
        n_groups = in_f // group
        s_shape = (1, out_f) if n_groups == 1 else (
            (out_f, n_groups) if transposed else (n_groups, out_f))
        s = (torch.rand(s_shape, generator=gen, device=dev) * 0.01 + 0.001).to(scales_dtype)
        x = torch.randn((rows, in_f), generator=gen, device=dev).to(dtype)
        kw = dict(bits=bits, group_size=group, transposed=transposed)
        if out_dtype is not None:
            kw["out_dtype"] = out_dtype
        sm.close("quant_matmul", m.dequant_matmul(x, q, s, **kw),
                 m.dequant_matmul_plain(x, q, s, **kw),
                 f"quant_matmul {name} {out_f}x{in_f} w{bits} g{group} "
                 f"{'transposed' if transposed else 'natural'} B={rows} {dtype} "
                 f"scales {scales_dtype} out {out_dtype or dtype}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def ffn_weights(torch, L, H, F, bits, gen, dev, dtype, scales_dtype=None):
    """Random act8 weights of the merged block, as check_a8 draws them."""
    k = 2 if bits == 4 else 1

    def q(o, i):
        return torch.randint(-128, 128, (L, o, i // k), generator=gen, device=dev,
                             dtype=torch.int8)

    def s(o):
        return (torch.rand((L, 1, o), generator=gen, device=dev) * 0.0015 + 0.0005).to(
            scales_dtype or torch.bfloat16)

    return dict(wo_q=q(H, H), wo_s=s(H),
                norm_w=(torch.rand((L, H), generator=gen, device=dev) + 0.5).to(dtype),
                w13_q=q(2 * F, H), w13_s=s(2 * F), w2_q=q(H, F), w2_s=s(H))


def ffn_norm_codes(torch, m, x2, w, layer, bits, act, offset, scratch):
    """The int8 codes of the normed x2 that the kernel's phase B multiplied:
    from its codes workspace at 2-16 rows (``scratch["norm_codes"]``). At one
    row every block quantizes in shared memory, so the block is called at 2
    rows on [x2; x2] with attn zero: phase A then passes x2 through
    unchanged (held exactly), and block 0 quantizes row 0 by the same code,
    at the same block size, as each block of the one-row launch."""
    if "norm_codes" in scratch:
        return scratch["norm_codes"]
    if x2.shape[0] != 1:
        raise AssertionError("ffn_block gave no norm codes at 2-16 rows")
    xx = x2.expand(2, -1).contiguous()
    two = {}
    m.ffn_block_stacked(torch.zeros_like(xx), xx, *w.values(), layer, bits=bits, act=act,
                        eps=1e-5, offset=offset, scratch=two)
    if x2.device.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(two["x2"], xx):
        raise AssertionError("ffn_block at 2 rows with attn zero changed x2")
    return two["norm_codes"][:1]


def moved_code_bound(torch, codes, want, w13_q, bits):
    """``[B, 2F]``: Σ over the codes that moved (``codes`` against the plain
    prologue's ``want``) of |Δcode| · |w13[:, i]| (the weight's own codes,
    int4 nibbles unpacked), and the count of moved codes in each row."""
    delta = codes.int() - want.int()
    out = torch.zeros((codes.shape[0], w13_q.shape[0]), dtype=torch.float32,
                      device=codes.device)
    half = codes.shape[1] // 2
    for r, i in delta.nonzero().tolist():
        if bits == 8:
            col = w13_q[:, i].int()
        elif i < half:
            col = (w13_q[:, i].int() & 15) - 8
        else:
            col = w13_q[:, i - half].int() >> 4
        out[r] += abs(int(delta[r, i])) * col.abs().float()
    return out, (delta != 0).sum(dim=1).tolist(), int(delta.abs().max())


def check_ffn_block(sm: Smoke, H, F, rows: int, cases, gen, dev, dtype=None, L=2):
    """The merged FFN block (row 10) against its plain version phase by
    phase, through the kernel's scratch (see ACT_SLOPE). Each case is (bits,
    act, offset, layer). Prints the normed codes the kernel moved by a
    quantum, case by case."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import ffn_block as m
    from metalchat_tpu_torch.ops.a8_matvec import prologue

    weights = {}
    moved_report = []
    for bits, act, offset, layer in cases:
        if bits not in weights:
            weights[bits] = ffn_weights(torch, L, H, F, bits, gen, dev, dtype)
        w = weights[bits]
        attn, x = (torch.randn((rows, H), generator=gen, device=dev).to(dtype)
                   for _ in range(2))
        scratch = {}
        got = m.ffn_block_stacked(attn, x, *w.values(), layer, bits=bits, act=act, eps=1e-5,
                                  offset=offset, scratch=scratch)
        x2, h = scratch["x2"], scratch["h"]
        what = (f"ffn_block H={H} F={F} w{bits} B={rows} {act} offset={offset} "
                f"layer={layer} {dtype}")
        sm.close("ffn_block", x2, m.wo_stage(attn, x, w["wo_q"][layer], w["wo_s"][layer],
                                             bits=bits), what + " phase A (x2)")
        h_ref, gate, up, sx_n = m.w13_stage(
            x2, w["norm_w"][layer], w["w13_q"][layer], w["w13_s"][layer], bits=bits, act=act,
            eps=1e-5, offset=offset)
        codes = ffn_norm_codes(torch, m, x2, w, layer, bits, act, offset, scratch)
        bound, per_row, step = moved_code_bound(
            torch, codes, prologue(x2, w["norm_w"][layer], 1e-5, offset)[0],
            w["w13_q"][layer], bits)
        moved_report.append(sum(per_row))
        sm.expect(step <= 1 and max(per_row) <= FFN_MOVED_CODES,
                  f"{what} phase B: the kernel's norm codes moved {per_row} a row, by up to "
                  f"{step} (at most {FFN_MOVED_CODES} a row, by one quantum)")
        s13 = w["w13_s"][layer].reshape(-1).float()
        dg, du = (bound * sx_n * s13[None]).split(F, dim=-1)
        moved = (ACT_SLOPE * up.abs() * dg + m.activation(gate, act).abs() * du
                 + ACT_SLOPE * dg * du)
        sm.close("ffn_block", h, h_ref, what + " phase B (h)", extra=moved)
        sm.close("ffn_block", got, m.w2_stage(h, x2, w["w2_q"][layer], w["w2_s"][layer],
                                              bits=bits)[0], what + " phase C (out)")
        if dev.type == "cuda":
            torch.cuda.synchronize()
    print(f"ffn_block H={H} F={F} B={rows}: normed codes the kernel moved by a quantum, "
          f"case by case: {moved_report}", flush=True)


# Row 1 at the 8b-w4a8 decode shapes (wqkv and w13 fused, with the norm
# prologue), int4, at each row count; int8 at two of them.
A8_8B = [("wqkv", 6144, 4096, 4, True), ("wo", 4096, 4096, 4, False),
         ("w13", 28672, 4096, 4, True), ("w2", 4096, 14336, 4, False),
         ("lm_head", 128256, 4096, 4, False)]
A8_8B_W8 = [("wo", 4096, 4096, 8, False), ("wqkv", 6144, 4096, 8, True)]
A8_ROWS = (1, 2, 3, 5, 8, 16)
# Row 1 at the 8B's tensor-parallel local shapes over two ranks (phase tp):
# wqkv and w13 at half their rows, wo and w2 at half their K (wo's 2048 is
# 1024 packed bytes), the lm_head's 64128 vocabulary rows (not a multiple
# of the 16-row tile); one row (the generate step) and 8 (the serve step).
A8_8B_TP2 = [("wqkv tp2", 3072, 4096, 4, True), ("wo tp2", 4096, 2048, 4, False),
             ("w13 tp2", 14336, 4096, 4, True), ("w2 tp2", 4096, 7168, 4, False),
             ("lm_head tp2", 64128, 4096, 4, False)]
# One row at edge widths: k not a multiple of the tile's 64-byte step (4128 /
# 2 = 2064 bytes, 14368, 96 / 2 = 48), out not a multiple of its 16 rows,
# with and without the norm, int4 and int8.
A8_EDGE = [("edge", 1003, 4128, 4, True), ("edge", 77, 14368, 8, True),
           ("edge", 4100, 96, 4, False), ("edge", 9, 2080, 8, False)]
# The speculative path: the 8b-w4a8 verify window at 4 rows (A8_8B); the
# Llama-3.2-1B draft, W8A8 unfused (the norm prologue on wq, wk, wv, w1 and
# w3), at one row and at its 2-token window; its row 5 at hd 64 over the
# draft's 582-position cache (the target's at hd 128 in the draft check).
A8_1B_W8 = [("wq", 2048, 2048, 8, True), ("wk/wv", 512, 2048, 8, True),
            ("wo", 2048, 2048, 8, False), ("w1/w3", 8192, 2048, 8, True),
            ("w2", 2048, 8192, 8, False)]
READ_CASES_SPEC = [([513], None), ([546], None), ([582], None)]
# Row 10's row counts: one row (dp4a, each block's own codes), one n-tile
# of the tensor-core tile (2, 5, 8) and two (16).
FFN_ROWS = (1, 2, 5, 8, 16)
# The fixture's widths (hidden 384, intermediate 1024), an int8 lm_head.
A8_FIXTURE = [("wqkv", 768, 384, 4, True), ("wo", 384, 384, 4, False),
              ("w13", 2048, 384, 4, True), ("w2", 384, 1024, 4, False),
              ("lm_head", 384, 384, 8, False)]
# Row 11 at the 8b-int4 shapes (bench.py --config 8b-int4: group 32, the fused
# wqkv, w13 and lm_head transposed, wo and w2 not) and the 1b-int8 shapes
# (Llama-3.2-1B widths, int8, group 32).
QMM_8B_INT4 = [("wqkv", 6144, 4096, 4, 32, True), ("wo", 4096, 4096, 4, 32, False),
               ("w13", 28672, 4096, 4, 32, True), ("w2", 4096, 14336, 4, 32, False),
               ("lm_head", 128256, 4096, 4, 32, True)]
QMM_1B_INT8 = [("wqkv", 3072, 2048, 8, 32, True), ("wo", 2048, 2048, 8, 32, False),
               ("w13", 16384, 2048, 8, 32, True), ("w2", 2048, 8192, 8, 32, False),
               ("lm_head", 128256, 2048, 8, 32, True)]
# qlora-1b's shapes (Llama-3.2-1B, int8 group 32, f32 scales, as
# `load_reference_qlora` stores them): the unfused wq, wk/wv, wo and w2
# natural, w1/w3 transposed, the tied head natural at out 128256.
QMM_QLORA_1B = [("wq", 2048, 2048, 8, 32, False), ("wk/wv", 512, 2048, 8, 32, False),
                ("wo", 2048, 2048, 8, 32, False), ("w1/w3", 8192, 2048, 8, 32, True),
                ("w2", 2048, 8192, 8, 32, False), ("lm_head", 128256, 2048, 8, 32, False)]
# Row 11 at a tp-2 rank's local shapes (phase tp-leaves): 8b-int4 fused as
# `make_8b` builds it (wqkv and w13 at half their rows, wo and w2 at half
# their in-features, the lm_head's 64128 vocabulary rows) and qlora-1b's
# (int8, f32 scales, every projection unfused, the tied head natural at
# 64128 columns). The row-parallel leaves (wo, w2) also in the f32-output
# mode, with one transposed leaf for the tensor-core route's store.
QMM_8B_INT4_TP2 = [("wqkv tp2", 3072, 4096, 4, 32, True), ("wo tp2", 4096, 2048, 4, 32, False),
                   ("w13 tp2", 14336, 4096, 4, 32, True), ("w2 tp2", 4096, 7168, 4, 32, False),
                   ("lm_head tp2", 64128, 4096, 4, 32, True)]
QMM_QLORA_1B_TP2 = [("wq tp2", 1024, 2048, 8, 32, False), ("wk/wv tp2", 256, 2048, 8, 32, False),
                    ("wo tp2", 2048, 1024, 8, 32, False), ("w1/w3 tp2", 4096, 2048, 8, 32, True),
                    ("w2 tp2", 2048, 4096, 8, 32, False),
                    ("lm_head tp2", 64128, 2048, 8, 32, False)]
QMM_ROW_PARALLEL_TP2 = [QMM_8B_INT4_TP2[1], QMM_8B_INT4_TP2[3], QMM_8B_INT4_TP2[2]]
QMM_QLORA_ROW_PARALLEL_TP2 = [QMM_QLORA_1B_TP2[2], QMM_QLORA_1B_TP2[4], QMM_QLORA_1B_TP2[3]]
# The fixture's widths, per-channel and group scales, both orientations.
QMM_FIXTURE = [("wqkv", 768, 384, 4, 32, True), ("wo", 384, 384, 4, 32, False),
               ("w13", 2048, 384, 8, 32, True), ("w2", 384, 1024, 8, 32, False),
               ("wo", 384, 384, 4, 384, False), ("w13", 2048, 384, 8, 384, True)]
# Row 10: (bits, act, offset, layer), layers 0 and L-1 of 2.
FFN_CASES = [(4, "silu", 0.0, 0), (4, "gelu_tanh", 1.0, 1), (8, "silu", 1.0, 1),
             (8, "gelu_tanh", 0.0, 0)]


# Lengths per row (the last row free): 1, a page edge and one past it, the
# table's last position, the serve run's range, and windows down to the new
# row alone.
PAGED_CASES_8B = [([1, 256, 257, 1024, 700, 513, 64, 1], None),
                  ([1024, 300, 257, 1, 256, 900, 5, 1], 100),
                  ([513, 1024, 2, 768, 129, 255, 1000, 1], 1)]
PAGED_CASES_FIXTURE = [([1, 16, 17, 1], None), ([128, 33, 5, 1], None),
                       ([40, 128, 12, 1], 10), ([17, 2, 128, 1], 1)]
# The kernel splits positions into chunks of SPLIT_CHUNK (32) that may cross
# pages: pages of 8 (4 to a chunk), of 48 (neither divides 32 nor is a
# multiple of it) and of 4 (the engine tests' size), lengths at the chunk
# edges (31, 32, 33, 65) and at page edges, windows whose lower edge lies
# inside a chunk (65 - 40 = 25, 96 - 50 = 46, 33 - 20 = 13).
PAGED_CASES_P8 = [([31, 32, 33, 65, 1, 128, 9, 1], None),
                  ([65, 33, 128, 32, 31, 100, 64, 1], 40),
                  ([100, 31, 64, 33, 2, 128, 17, 1], 1)]
PAGED_CASES_P48 = [([31, 32, 33, 65, 48, 49, 192, 1], None),
                   ([96, 65, 190, 33, 47, 1, 150, 1], 50),
                   ([192, 97, 32, 31, 145, 3, 65, 1], 1)]
PAGED_CASES_P4 = [([31, 32, 33, 1], None), ([65, 128, 3, 1], 20), ([33, 4, 64, 1], 1)]


# The decode kernel's chunk of positions a block
# (metalchat_tpu_torch.ops.decode_attention.SPLIT_CHUNK; phase kernels checks
# that they agree).
SPLIT_CHUNK = 32
C = SPLIT_CHUNK
# Lengths at chunk edges (C - 1, C, C + 1, 2C + 1) and at the 64-position
# edges, length 1, the main path's lengths (513-576), the full context,
# windows down to the new row alone and windows whose lower edge lies inside
# a chunk, and zeroed caches.
DECODE_CASES_8B = [([1], None, "random"), ([C - 1], None, "random"), ([C], None, "random"),
                   ([C + 1], None, "random"), ([2 * C + 1], None, "random"),
                   ([64], None, "random"), ([65], None, "random"),
                   ([576], None, "random"), ([1024], None, "random"),
                   ([700], 100, "random"), ([577], 3 * C - 7, "random"),
                   ([576], 1, "random"), ([577], 2, "random"),
                   ([576], None, "zeros"), ([1024], None, "zeros")]
DECODE_CASES_FIXTURE = [([1, 64, 65], None, "random"), ([200, 17, 256], 50, "random"),
                        ([2, 64, 130], None, "zeros"), ([65, 128, 256], 1, "random")]
# Flash: (start_pos, window); a list is one start per batch row.
FLASH_CASES_FIXTURE = [(0, None), ([0, 17, 64], None), (0, 20), ([63, 1, 0], 1)]
# The serve path's shapes: 8 rows at per-row lengths up to the context (1024),
# one free row at length 1; flash over 256-token chunks at per-row offsets.
# The last case leaves most of the 32 chunks of every row dead.
DECODE_CASES_SERVE = [([1, 64, 65, 300, 577, 1024, 700, 129], None, "random"),
                      ([1024, 256, 257, 1, 900, 513, 64, 1], 100, "random"),
                      ([600, 1024, 2, 768, 129, 255, 1000, 1], None, "zeros"),
                      ([1, C, C + 1, 3, 2 * C + 1, 1, C - 1, 5], None, "random")]
READ_CASES_SERVE = [([1, 64, 65, 300, 577, 1024, 700, 129], None),
                    ([1024, 256, 257, 1, 900, 513, 64, 1], 100),
                    ([600, 1024, 2, 768, 129, 255, 1000, 1], 1)]
READ_CASES_FIXTURE = [([1, 64, 65], None), ([200, 17, 256], 50), ([65, 128, 256], 1)]
FLASH_CASES_SERVE = [([0, 256, 512, 768, 100, 37, 640, 0], None),
                     ([768, 0, 300, 1, 512, 700, 256, 64], None)]
# Flash at the 8B shapes: 512 tokens from 0 and from an unaligned start,
# windows; then a ragged S (the serve path's last chunk) from unaligned starts.
FLASH_CASES_8B = [(0, None), (100, None), (0, 128), (64, 1)]
FLASH_RAGGED_S = 137
FLASH_CASES_RAGGED = [(100, None), (37, 70), (0, 1)]


# Gemma-3-1B (hd 256, 4 query heads over 1 kv head, window 512 on 5 of every
# 6 layers). Row 1 at its decode shapes, int8, the norm prologue at offset 1.
A8_GEMMA = [("wqkv", 1536, 1152, 8, True), ("wo", 1152, 1024, 8, False),
            ("w13", 13824, 1152, 8, True), ("w2", 1152, 6912, 8, False),
            ("lm_head", 262144, 1152, 8, False)]
GEMMA_WINDOW = 512
W = GEMMA_WINDOW
# Rows 3 and 5: windows that drop positions (lengths 600, 641 and 1024 under
# a window of 512, whose lower edge then lies inside a chunk: 600 - 512 = 88),
# a length under the window, the global layer's -1, a chunk edge, a zeroed
# cache.
DECODE_CASES_GEMMA = [([1], W, "random"), ([C + 1], None, "random"), ([300], W, "random"),
                      ([600], W, "random"), ([641], W, "random"), ([1024], W, "random"),
                      ([1024], -1, "random"), ([600], None, "random"),
                      ([1024], W, "zeros")]
READ_CASES_GEMMA = [([1, 64, 300, 600, 1024, 513, 700, 129], W),
                    ([600, 1024, 2, 768, 129, 255, 1000, 1], None)]
# Row 8 (9): the serve path's 8 rows on pages of 256 (4 a row), and pages of
# 48 (chunks cross pages), windows of 512 and global.
PAGED_CASES_GEMMA = [([600, 1024, 300, 1, 513, 1000, 64, 1], W),
                     ([1, 256, 257, 1024, 700, 513, 64, 1], None),
                     ([1024, 600, 2, 768, 129, 255, 1000, 1], -1)]
PAGED_CASES_GEMMA_P48 = [([600, 1056, 49, 700, 96, 1, 530, 1], W)]
# Row 4: the generate path's 640-token prefill over a cache of 1024, sliding
# and global; a ragged chunk from unaligned starts.
FLASH_CASES_GEMMA = [(0, W), (0, None), (0, -1), (100, W)]
FLASH_CASES_GEMMA_RAGGED = [(100, W), (37, 70), (600, W)]
# Rows 6 and 7 at a tp-2 rank's Gemma-3-1B shape (phase train-tp (b)): the
# steps' lengths after its 128-token prompt, a sliding and a global layer.
GEMMA_TP2_ONE_LAYER = [([129], W), ([136], -1)]


# Row 1 with a device index at Mixtral-8x7B's expert widths (w1 and w3: 4096
# → 14336, w2: 14336 → 4096) over a flattened stack of 32 layers × 8
# experts; w2's entry 255 starts 255 × 29,360,128 = 7.49e9 bytes in, past
# 2^31 (as does w1's).
A8_MIXTRAL = [("w1/w3", 14336, 4096), ("w2", 4096, 14336)]
# The same at a rank's expert width under tp 2 (phase tp-moe's local stacks:
# w1/w3 4096 → 7168, w2 7168 → 4096, its int4 repacked per chunk by
# `shard_params` into a standard leaf of the local shape).
A8_MIXTRAL_TP2 = [("w1/w3 tp2", 7168, 4096), ("w2 tp2", 4096, 7168)]
A8_MIXTRAL_ENTRIES = (0, 7, 128, 255)
MIXTRAL_STACK = 32 * 8
# Rows 6 and 7 at the 8B one-layer shapes: generate's one row (lengths at
# chunk edges, the main path's, the full context, windows) and 8 rows.
ONE_LAYER_CASES_1 = [([1], None), ([C + 1], None), ([576], None), ([1024], None),
                     ([700], 100), ([577], 1)]


def mixtral_kernel_checks(sm: Smoke, gen, dev):
    """Row 1 indexed at Mixtral's widths and at a tp-2 rank's, 1 and 2 rows;
    rows 6 and 7 at the 8B shapes (1 row and 8)."""
    torch = sm.torch
    for shapes in (A8_MIXTRAL, A8_MIXTRAL_TP2):
        check_a8_indexed(sm, shapes, (1, 2), A8_MIXTRAL_ENTRIES, MIXTRAL_STACK, gen, dev)
    check_one_layer(sm, 1, 32, 8, 1024, 128, ONE_LAYER_CASES_1, 256, gen, dev)
    check_one_layer(sm, 8, 32, 8, 1024, 128, READ_CASES_SERVE, 256, gen, dev)
    check_one_layer(sm, 8, 32, 8, 1024, 128, READ_CASES_SERVE[:1], 256, gen, dev,
                    torch.float32)


def speculative_kernel_checks(sm: Smoke, gen, dev):
    """Rows 1, 4 and 5 at the speculative phase's shapes (A8_1B_W8)."""
    check_a8(sm, A8_8B, 4, gen, dev)
    for rows in (1, 2):
        check_a8(sm, A8_1B_W8, rows, gen, dev)
    check_decode_read(sm, 1, 32, 8, 582, 64, READ_CASES_SPEC, gen, dev)
    check_decode_read(sm, 1, 32, 8, 256, 128, [([12], None), ([256], None)], gen, dev)
    check_flash(sm, 1, 512, 32, 8, 582, 64, [(0, None)], gen, dev)


def gemma_kernel_checks(sm: Smoke, gen, dev):
    """Rows 1, 3, 4, 5 and 8 (9) at Gemma-3-1B's shapes (hd 256)."""
    torch = sm.torch
    for rows in (1, 8):
        check_a8(sm, A8_GEMMA, rows, gen, dev, norm_offset=1.0)
    check_decode(sm, 1, 4, 1, 1024, 256, DECODE_CASES_GEMMA, gen, dev)
    check_decode(sm, 1, 4, 1, 1024, 256, DECODE_CASES_GEMMA[:4], gen, dev, torch.float32)
    check_decode_read(sm, 8, 4, 1, 1024, 256, READ_CASES_GEMMA, gen, dev)
    check_decode_read(sm, 8, 4, 1, 1024, 256, READ_CASES_GEMMA, gen, dev, kv="int8")
    check_decode_read(sm, 8, 4, 1, 1024, 256, READ_CASES_GEMMA[:1], gen, dev, torch.float32)
    check_flash(sm, 1, 640, 4, 1, 1024, 256, FLASH_CASES_GEMMA, gen, dev)
    check_flash(sm, 2, FLASH_RAGGED_S, 4, 1, 1024, 256, FLASH_CASES_GEMMA_RAGGED, gen, dev)
    check_flash(sm, 1, FLASH_RAGGED_S, 4, 1, 768, 256, FLASH_CASES_GEMMA_RAGGED, gen, dev,
                torch.float32)
    check_paged(sm, 8, 4, 1, 256, 256, 4, PAGED_CASES_GEMMA, gen, dev)
    check_paged(sm, 8, 4, 1, 256, 48, 22, PAGED_CASES_GEMMA_P48, gen, dev)
    check_paged(sm, 8, 4, 1, 256, 256, 4, PAGED_CASES_GEMMA[:1], gen, dev, torch.float32)
    # A tp-2 rank's shapes on the sharded layer route (phase train-tp (b)):
    # 2 query heads over the one kv-head, a 128-token prefill (its keys the
    # 128 written positions), then one-token steps over an int8 cache of 256,
    # sliding and global.
    check_flash(sm, 1, LEAVES_PROMPT, 2, 1, LEAVES_PROMPT, 256, [(0, W), (0, -1)], gen, dev)
    check_one_layer(sm, 1, 2, 1, LEAVES_CACHE, 256, GEMMA_TP2_ONE_LAYER, LEAVES_CACHE, gen,
                    dev)


def phase_kernels(sm: Smoke):
    torch = sm.torch
    from metalchat_tpu_torch.ops.decode_attention import SPLIT_CHUNK as kernel_chunk

    sm.expect(kernel_chunk == SPLIT_CHUNK,
              f"decode chunk {kernel_chunk} != chip_smoke.SPLIT_CHUNK {SPLIT_CHUNK}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # One row (the generate path), then 2-16 rows (a8_quantize and the
    # tensor-core matvec: one n-tile up to 8 rows, two above; the serve decode
    # step is 8 rows), int4, and int8 at 1 and 8 rows.
    for rows in A8_ROWS:
        check_a8(sm, A8_8B, rows, gen, dev)
    for rows in (1, 8):
        check_a8(sm, A8_8B_W8, rows, gen, dev)
    for dtype in (torch.bfloat16, torch.float32):
        check_a8(sm, A8_EDGE, 1, gen, dev, dtype)
    check_a8(sm, A8_FIXTURE, 3, gen, dev)
    check_decode(sm, 1, 32, 8, 1024, 128, DECODE_CASES_8B, gen, dev)
    check_decode(sm, 8, 32, 8, 1024, 128, DECODE_CASES_SERVE, gen, dev)
    check_decode(sm, 3, 6, 3, 256, 64, DECODE_CASES_FIXTURE, gen, dev)
    check_decode_read(sm, 8, 32, 8, 1024, 128, READ_CASES_SERVE, gen, dev)
    check_decode_read(sm, 8, 32, 8, 1024, 128, READ_CASES_SERVE, gen, dev, kv="int8")
    check_decode_read(sm, 3, 6, 3, 256, 64, READ_CASES_FIXTURE, gen, dev, torch.float32)
    check_flash(sm, 1, 512, 32, 8, 1024, 128, FLASH_CASES_8B, gen, dev)
    check_flash(sm, 1, FLASH_RAGGED_S, 32, 8, 1024, 128, FLASH_CASES_RAGGED, gen, dev)
    check_flash(sm, 8, 256, 32, 8, 1024, 128, FLASH_CASES_SERVE, gen, dev)
    check_flash(sm, 3, 48, 6, 3, 256, 64, FLASH_CASES_FIXTURE, gen, dev)
    check_paged(sm, 8, 32, 8, 128, 256, 4, PAGED_CASES_8B, gen, dev)
    check_paged(sm, 8, 32, 8, 128, 8, 16, PAGED_CASES_P8, gen, dev)
    check_paged(sm, 8, 32, 8, 128, 48, 4, PAGED_CASES_P48, gen, dev)
    check_paged(sm, 4, 6, 3, 64, 16, 8, PAGED_CASES_FIXTURE, gen, dev)
    check_paged(sm, 4, 6, 3, 64, 4, 32, PAGED_CASES_P4, gen, dev)
    for rows in (1, 8, 32):
        check_qmm(sm, QMM_8B_INT4, rows, gen, dev)
        check_qmm(sm, QMM_1B_INT8, rows, gen, dev)
    check_qmm(sm, QMM_FIXTURE, 3, gen, dev, torch.float32, torch.float32)
    # qlora-1b's shapes draw from a generator of their own, so the checks
    # after them see the inputs they saw before these shapes were added.
    gen_qlora = torch.Generator(device=dev)
    gen_qlora.manual_seed(17)
    for rows in (1, 8):
        check_qmm(sm, QMM_QLORA_1B, rows, gen_qlora, dev, scales_dtype=torch.float32)
    gen_tp = torch.Generator(device=dev)  # a generator of their own, as qlora-1b's
    gen_tp.manual_seed(19)
    for rows in (1, 8):
        check_a8(sm, A8_8B_TP2, rows, gen_tp, dev)
    gen_leaves = torch.Generator(device=dev)  # phase tp-leaves' shapes, a generator of their own
    gen_leaves.manual_seed(23)
    for rows in (1, 8):
        check_qmm(sm, QMM_8B_INT4_TP2, rows, gen_leaves, dev)
        check_qmm(sm, QMM_QLORA_1B_TP2, rows, gen_leaves, dev, scales_dtype=torch.float32)
        check_qmm(sm, QMM_ROW_PARALLEL_TP2, rows, gen_leaves, dev, out_dtype=torch.float32)
        check_qmm(sm, QMM_QLORA_ROW_PARALLEL_TP2, rows, gen_leaves, dev,
                  scales_dtype=torch.float32, out_dtype=torch.float32)
    for rows in FFN_ROWS:
        check_ffn_block(sm, 4096, 14336, rows, FFN_CASES, gen, dev)
    check_graph_replay(sm, 2, 32, 8, 1024, 128, gen, dev)
    speculative_kernel_checks(sm, gen, dev)
    gemma_kernel_checks(sm, gen, dev)
    mixtral_kernel_checks(sm, gen, dev)
    gpt2_kernel_checks(sm, gen, dev)
    print("max |kernel - plain| in bf16 (raw int32 and cache bytes exact; a8_quantize "
          "in int8 code quanta): "
          + ", ".join(f"{k} {v:.3g} ({sm.share[k]:.3g} of its limit)"
                      for k, v in sm.err.items()))


# -- phase 4: the fixture end to end ---------------------------------------------

def phase_fixture(sm: Smoke):
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    outs = {}
    for device in ("cuda", "cpu"):
        params, cfg, fixture = fixture_params(torch, device)
        prompts = torch.from_numpy(
            np.load(fixture / "eval_tokens.npy")[:3 * 48].astype(np.int64).reshape(3, 48))
        reset_launch_counts()
        outs[device] = generate(params, cfg, prompts, max_new_tokens=64,
                                quantized_kv=True).cpu()
        if device == "cuda":
            counts = launch_counts()
    agree = (outs["cuda"] == outs["cpu"]).float().mean().item()
    first16 = bool(torch.equal(outs["cuda"][:, :16], outs["cpu"][:, :16]))
    print(f"fixture w4a8+int8kv, 3 requests x 64 tokens: card vs CPU plain "
          f"agreement {agree:.4f}, first 16 identical: {first16}, launches {counts}")
    sm.expect(first16, "fixture: first 16 greedy tokens differ between card and CPU")
    sm.expect(all(counts[k] > 0 for k in GENERATE_KERNELS),
              f"fixture: a kernel never ran {counts}")
    # Decode runs 3 rows: every fused matvec call quantizes its rows once.
    sm.expect(counts["a8_quantize"] == counts["a8_matvec"],
              f"fixture: a8_quantize {counts['a8_quantize']} != a8_matvec {counts['a8_matvec']}")


# -- phase 5: 8b-w4a8 at full width --------------------------------------------

def weight_bytes(params) -> int:
    """bench.py's accounting: every weight except the embedding table (one
    row is gathered), GPT-2's position table (one row too) and the rope
    tables."""
    from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

    def nbytes(node):
        if isinstance(node, QuantizedTensor):
            return nbytes(node.q) + nbytes(node.scales)
        if isinstance(node, LoraLinear):
            return nbytes(node.base) + nbytes(node.a) + nbytes(node.b)
        if isinstance(node, dict):
            return sum(nbytes(v) for v in node.values())
        return node.numel() * node.element_size()

    return (nbytes(params) - nbytes(params["rope"]) - nbytes(params["embed"])
            - (nbytes(params["pos_emb"]) if "pos_emb" in params else 0))


def eager_generate(params, cfg, prompt, n_new: int, cache, ffn_block: bool = False):
    """Greedy decode as a loop of plain `forward` calls, one a token at an
    int position: the loop `generate` ran before its step was captured,
    written here as the graph route's reference. Returns the ids ``[B,
    n_new]`` and the last step's logits."""
    import torch

    from metalchat_tpu_torch.models.transformer import forward

    s = prompt.shape[1]
    logits, _ = forward(params, cache, prompt, 0, cfg, ffn_block=ffn_block)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for i in range(n_new - 1):
        logits, _ = forward(params, cache, tok[:, None], s + i, cfg, ffn_block=ffn_block)
        tok = logits[:, -1].argmax(-1)
        out.append(tok)
    return torch.stack(out, dim=1), logits


def eager_stream(params, cfg, prompt, n_new: int, cache, sink_tokens: int):
    """`generate_stream`'s loop (greedy, batch of one, no EOS) as plain
    `forward` calls at int positions, rolling the cache as it does. Returns
    the ids and the number of rolls."""
    import torch

    from metalchat_tpu_torch.cache import roll_kv_cache
    from metalchat_tpu_torch.models.transformer import forward

    dev = params["final_norm"].device
    logits, _ = forward(params, cache, torch.tensor([list(prompt)], device=dev), 0, cfg)
    pos, out, rolls = len(prompt), [], 0
    for _ in range(n_new):
        tok = int(logits[0, -1].argmax())
        out.append(tok)
        if pos + 1 >= cache.max_seq_len:
            shift = max(1, (cache.max_seq_len - sink_tokens) // 4)
            roll_kv_cache(cache, sink_tokens, shift)
            pos, rolls = pos - shift, rolls + 1
        logits, _ = forward(params, cache, torch.tensor([[tok]], device=dev), pos, cfg)
        pos += 1
    return out, rolls


def drive_generate(sm: Smoke, dev_name: str, label: str, cfg, params, per_step,
                   ffn_block: bool = False, ctx: int = 1024, prompt_len: int = 512,
                   new: int = 64, weights_per_token=None):
    """One user's request through `generate` at full width: int8 KV, batch
    1, a random 512-token prompt, then 64 greedy decode steps (one eager
    warm-up step, the capture, 63 replays of the CUDA graph). Prints decode
    tok/s, TTFT, bytes a token and the HBM share (bench.py's accounting;
    ``weights_per_token`` replaces its weight bytes where a token reads
    less than every weight, as routed experts do).
    Launches are read around the timed runs and held exactly: ``per_step``
    a decode step, replays included, flash once a layer a prefill, every
    other kernel never. Then `graph_vs_eager`."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev)

    def run(n_new):
        cache = QuantizedKVCache.create(cfg, 1, ctx, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(params, cfg, prompt, max_new_tokens=n_new, cache=cache,
                       ffn_block=ffn_block)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out, cache

    run(2)  # warm-up: libraries, cuBLAS handles, first launches, one capture
    reset_launch_counts()
    ttft, _, _ = run(1)
    total, out, cache = run(new + 1)
    counts = launch_counts()
    decode_s = total - ttft
    tok_s = new / decode_s
    kv_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * (ctx / 2) * (cfg.head_dim + 4)
    bpt = (weights_per_token or weight_bytes(params)) + cfg.hidden_size * 2 + kv_bytes
    rate = hbm_rate(dev_name)
    sm.expect(out.shape == (1, new + 1) and bool((out >= 0).all())
              and bool((out < cfg.vocab_size).all()), f"{label}: bad tokens {out.shape}")
    want = dict.fromkeys(counts, 0)
    want.update({k: n * new for k, n in per_step.items()})
    want["flash_attention"] = 2 * cfg.num_layers
    sm.tok_s[label] = tok_s
    print(f"{label}: decode {tok_s:.2f} tok/s through generate (the graph route, its "
          f"warm-up step and capture included), TTFT {1e3 * ttft:.2f} ms "
          f"(prompt {prompt_len}), {bpt / 1e9:.4f} GB/token (bound "
          f"{1e3 * bpt / rate:.4f} ms a step), {tok_s * bpt / rate:.4f} of "
          f"{rate / 1e12:.2f} TB/s HBM, launches {counts}")
    sm.expect(counts == want, f"{label}: launches {counts} != expected {want}")
    graph_vs_eager(sm, label, cfg, params, prompt, out, cache, ffn_block, ctx, new)
    return cfg, params, cache, counts, prompt_len + new, prompt


# The eager turns of `graph_vs_eager` decode new / 2 tokens: the loop is 5-10x
# slower than the graph route, and its rate past the first step is steady
# (halved for the script's time limit: 2 x 64 eager tokens took 0.8-12.7 s a
# phase on an H100, about 45 s over the eight phases).
EAGER_TURN_DIVISOR = 2


def graph_vs_eager(sm: Smoke, label: str, cfg, params, prompt, out, cache, ffn_block: bool,
                   ctx: int, new: int):
    """The graph route against `eager_generate` on the card: the same ids
    and the same cache, bit for bit. Then decode tok/s of the two routes in
    turns (graph, eager, eager, graph; the graph route's 64 / (t(65) -
    t(1)), its warm-up step and capture inside its t(65); the eager loop's
    32 / (t(33) - t(1)), `EAGER_TURN_DIVISOR`), the capture alone
    (`CountedGraph.capture`, timed), and the decode rate of replays alone:
    63 replays of a step captured by `make_decode_step`, enqueued with no
    host read between them."""
    torch = sm.torch
    import importlib

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.sampling import SamplerConfig

    # The module, not the function `engine.generate` that shadows its name.
    gm = importlib.import_module("metalchat_tpu_torch.engine.generate")
    dev = torch.device("cuda")

    def fresh():
        return QuantizedKVCache.create(cfg, 1, ctx, device=dev)

    eager_cache = fresh()
    want, _ = eager_generate(params, cfg, prompt, new + 1, eager_cache, ffn_block)
    sm.exact(out, want, f"{label}: graph route ids against the eager loop")
    for name in ("k", "v", "k_scale", "v_scale"):
        sm.exact(getattr(cache, name), getattr(eager_cache, name),
                 f"{label}: cache {name}, graph route against the eager loop")

    def timed(route, n_new):
        c = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if route == "graph":
            gm.generate(params, cfg, prompt, max_new_tokens=n_new, cache=c,
                        ffn_block=ffn_block)
        else:
            eager_generate(params, cfg, prompt, n_new, c, ffn_block)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    turns = []
    for route in ("graph", "eager", "eager", "graph"):
        n = new if route == "graph" else new // EAGER_TURN_DIVISOR
        first = timed(route, 1)
        total = timed(route, n + 1)
        turns.append((route, n / (total - first), first, total, n))

    captures = []
    base = gm.CountedGraph

    class TimedCapture(base):
        def capture(self, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = super().capture(fn)
            torch.cuda.synchronize()
            captures.append(time.perf_counter() - t)
            return result

    greedy = SamplerConfig.greedy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = gm.make_prefill(cfg, greedy, (), ffn_block)(params, fresh(), prompt, 0, gen)
    step = gm.make_decode_step(cfg, greedy, (), ffn_block)
    gm.CountedGraph = TimedCapture
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.advance(params, state)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t)
    finally:
        gm.CountedGraph = base
    t = time.perf_counter()
    for _ in range(new - 1):
        step.advance(params, state)
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t) / (new - 1)
    print(f"{label}: decode tok/s in turns: "
          + ", ".join(f"{r} {v:.2f} (t(1) {1e3 * a:.1f} ms, t({n + 1}) {1e3 * b:.1f} ms)"
                      for r, v, a, b, n in turns)
          + f"; capture {1e3 * captures[0]:.3f} ms (first step call {first_ms:.3f} ms: an "
          f"eager step, then the capture); {new - 1} replays {replay_ms:.4f} ms a step "
          f"({1e3 / replay_ms:.2f} tok/s); ids and cache equal to the eager loop's")


def make_8b(sm: Smoke, label: str, **quant):
    """Llama-3.1-8B geometry at full width, context 1024, random quantized
    weights from a seeded torch.Generator, wqkv and w13 fused."""
    torch = sm.torch
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    cfg = LlamaConfig.llama31_8b(max_seq_len=1024)
    t0 = time.perf_counter()
    params = fuse_projections(init_random_quantized_params(
        cfg, max_seq_len=1024, seed=0, device=torch.device("cuda"), **quant), cfg)
    torch.cuda.synchronize()
    print(f"{label} params: {weight_bytes(params) / 1e9:.3f} GB of weights, made in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def phase_main(sm: Smoke, dev_name: str):
    """8b-w4a8 (bench.py:78-84): per-channel int4, int8 activations."""
    cfg, params = make_8b(sm, "8b-w4a8", bits=4, group_size=None, act_bits=8)
    L = cfg.num_layers
    return drive_generate(sm, dev_name, "8b-w4a8 main path", cfg, params,
                          {"a8_matvec": 4 * L + 1, "a8_quantize": 4 * L + 1,
                           "decode_attention_update": L})


def phase_main_int4(sm: Smoke, dev_name: str):
    """8b-int4 (bench.py:73-77): weight-only int4, group 32. Every decode
    linear is the dequant-matmul kernel (4 a layer and lm_head); the prompt
    takes the dequantized weights and torch.matmul."""
    cfg, params = make_8b(sm, "8b-int4", bits=4, group_size=32)
    L = cfg.num_layers
    layout = {n: (tuple(w.q.shape), w.transposed) for n, w in
              [*params["layers"].items(), ("lm_head", params["lm_head"])]
              if hasattr(w, "q")}
    print(f"8b-int4 layouts (q shape, transposed): {layout}")
    return drive_generate(sm, dev_name, "8b-int4", cfg, params,
                          {"quant_matmul": 4 * L + 1, "decode_attention_update": L})


def phase_main_ffn_block(sm: Smoke, main, dev_name: str):
    """Phase main's 8b-w4a8 params with the merged FFN block: one ffn_block
    launch a layer, a8_matvec for wqkv and lm_head."""
    cfg, params = main[0], main[1]
    L = cfg.num_layers
    run = drive_generate(sm, dev_name, "8b-w4a8 ffn_block", cfg, params,
                         {"ffn_block": L, "a8_matvec": L + 1, "a8_quantize": L + 1,
                          "decode_attention_update": L},
                         ffn_block=True)
    print(f"8b-w4a8 decode: ffn_block {sm.tok_s['8b-w4a8 ffn_block']:.2f} tok/s beside "
          f"unmerged {sm.tok_s['8b-w4a8 main path']:.2f} tok/s (one run each, the same "
          "params and prompt)")
    # The two routes in turns (unmerged, merged, merged, unmerged), 64 decode
    # steps each after the same prefill: the host's pace drifts between runs.
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import generate

    prompt = run[5]
    turns = []
    for merged in (False, True, True, False):
        times = []
        for n_new in (1, 65):
            cache = QuantizedKVCache.create(cfg, 1, 1024, device=torch.device("cuda"))
            torch.cuda.synchronize()
            t = time.perf_counter()
            generate(params, cfg, prompt, max_new_tokens=n_new, cache=cache, ffn_block=merged)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        turns.append((merged, 64 / (times[1] - times[0])))
    print("8b-w4a8 decode tok/s in turns: " + ", ".join(
        f"{'ffn_block' if m else 'unmerged'} {v:.2f}" for m, v in turns))
    phase_profile(sm, run, "8b-w4a8 ffn_block", ffn_block=True, prefill=False)
    return run


def phase_stream(sm: Smoke, main):
    """`generate_stream` at full width: phase main's 8b-w4a8 params, a dense
    bf16 cache of 1024 positions, 4 sink positions, a random 960-token
    prompt and 128 greedy tokens, so the cache rolls (255 positions) and
    the captured step replays on after it. The ids must equal
    `eager_stream`'s on the card; launches are held exactly (128 steps,
    the warm-up step and the replays; one flash prefill). Then the
    fixture's stream (W4A8, a 56-position cache that rolls after 7 tokens)
    card against CPU: the first 16 ids identical and not one id repeated."""
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.engine.generate import generate_stream
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.sampling import SamplerConfig

    cfg, params = main[0], main[1]
    L, n_new, ctx, sinks = cfg.num_layers, 128, 1024, 4
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (960,), generator=gen, device=dev).tolist()
    greedy = SamplerConfig.greedy()

    def cache():
        return KVCache.create(cfg, 1, ctx, dtype=torch.bfloat16, device=dev)

    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = list(generate_stream(params, cfg, prompt, max_new_tokens=n_new, sampler=greedy,
                               cache=cache(), sink_tokens=sinks))
    stream_s = time.perf_counter() - t
    counts = launch_counts()
    t = time.perf_counter()
    want, rolls = eager_stream(params, cfg, prompt, n_new, cache(), sinks)
    eager_s = time.perf_counter() - t
    expected = dict.fromkeys(counts, 0)
    expected.update(a8_matvec=(4 * L + 1) * n_new, a8_quantize=(4 * L + 1) * n_new,
                    decode_attention=L * n_new, flash_attention=L)
    print(f"stream 8b-w4a8 (prompt 960, dense bf16 cache {ctx}, {sinks} sinks): "
          f"{n_new} tokens, {rolls} roll(s); graph route {stream_s:.3f} s, eager loop "
          f"{eager_s:.3f} s (each with its 960-token prefill); ids equal: {got == want}; "
          f"launches {counts}")
    sm.expect(len(got) == n_new and rolls >= 1, f"stream: {len(got)} ids, {rolls} rolls")
    sm.expect(got == want, "stream: graph route ids differ from the eager loop's")
    sm.expect(counts == expected, f"stream: launches {counts} != expected {expected}")

    outs = {}
    for device in ("cuda", "cpu"):
        fparams, fcfg, fixture = fixture_params(torch, device, torch.float32)
        fprompt = np.load(fixture / "eval_tokens.npy")[STREAM_FIXTURE_PROMPT].tolist()
        outs[device] = list(generate_stream(fparams, fcfg, fprompt, max_new_tokens=32,
                                            sampler=greedy, max_seq_len=56, sink_tokens=4))
    first = outs["cuda"][:16]
    print(f"stream fixture (W4A8, f32, cache 56, 4 sinks): card {first}, CPU "
          f"{outs['cpu'][:16]}, all 32 equal: {outs['cuda'] == outs['cpu']}")
    sm.expect(first == outs["cpu"][:16],
              "stream fixture: the first 16 ids differ between card and CPU")
    sm.expect(len(set(first)) > 4, f"stream fixture: a degenerate stream {first}")
    return counts


# -- Gemma-3-1B W8A8 at full width --------------------------------------------

W8A8 = dict(bits=8, group_size=None, act_bits=8)
GEMMA_LABEL = "gemma3-1b-w8a8"


def make_gemma(sm: Smoke, device, **cut):
    """Gemma-3-1B at its published widths (bench.py:103-111, gemma3-1b-int8:
    W8A8 per-channel, int8 KV, context 1024), random weights from a seeded
    torch.Generator on ``device``, wqkv and w13 fused; ``cut`` replaces
    config fields (the fixture's depth and window)."""
    torch = sm.torch
    from metalchat_tpu_torch.config import Gemma3Config
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    cfg = Gemma3Config.gemma3_1b(**{"max_seq_len": 1024, **cut})
    t0 = time.perf_counter()
    params = fuse_projections(init_random_quantized_params(
        cfg, max_seq_len=cfg.max_seq_len, seed=0, device=torch.device(device), **W8A8), cfg)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    print(f"{GEMMA_LABEL} params ({cfg.num_layers} layers, window {cfg.sliding_window}, "
          f"a global layer every {cfg.sliding_window_pattern}): "
          f"{weight_bytes(params) / 1e9:.4f} GB of weights, made in "
          f"{time.perf_counter() - t0:.1f} s on {device}")
    return cfg, params


def phase_gemma(sm: Smoke, dev_name: str):
    """Gemma-3-1B W8A8 (all 26 layers) through `generate`: a 640-token
    prompt, so that the prefill's sliding layers mask, then 64 greedy
    tokens; launches exact (105 a8_matvec and 26 decode_attention_update a
    step, 26 flash a prefill, nothing else), the graph route equal to the
    eager loop; its profile; then `gemma_window_check`."""
    cfg, params = make_gemma(sm, "cuda")
    L = cfg.num_layers
    run = drive_generate(sm, dev_name, GEMMA_LABEL, cfg, params,
                         {"a8_matvec": 4 * L + 1, "a8_quantize": 4 * L + 1,
                          "decode_attention_update": L}, prompt_len=640)
    phase_profile(sm, run, GEMMA_LABEL)
    gemma_window_check(sm, cfg, params, run[5])
    return run


def gemma_window_check(sm: Smoke, cfg, params, prompt):
    """The windows reach the kernels: on the same params and prompt, the
    prefill's last logits and the first decode step's differ between window
    512 and a window of 1024 (no position of the 641 dropped, the same rope
    table a layer), and between window 512 and none (every layer global,
    as the JAX package reads ``sliding_window=None``)."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    dev = torch.device("cuda")
    s = prompt.shape[1]
    out = {}
    for window in (cfg.sliding_window, 1024, None):
        c = cfg.replace(sliding_window=window)
        cache = QuantizedKVCache.create(c, 1, cfg.max_seq_len, device=dev)
        pre, _ = forward(params, cache, prompt, 0, c)
        step, _ = forward(params, cache, pre[:, -1].argmax(-1)[:, None], s, c)
        out[window] = (pre[:, -1], step[:, -1])
    base = out[cfg.sliding_window]
    for window in (1024, None):
        d = [(a - b).abs().max().item() for a, b in zip(base, out[window])]
        print(f"{GEMMA_LABEL} window check: window {cfg.sliding_window} against {window}: "
              f"max |logit diff| prefill {d[0]:.4g}, first decode step {d[1]:.4g}")
        sm.expect(min(d) > 0, f"window check: window {window} gives the same logits as "
                  f"{cfg.sliding_window}: the window does not reach the kernels")


# The correctness cell: Gemma-3-1B's widths cut to 2 layers, a window of 64
# and every 2nd layer global (one sliding, one global layer), so that a
# 96-token prompt drops positions and the CPU's plain path stays short.
GEMMA_FIXTURE_CUT = dict(num_layers=2, sliding_window=64, sliding_window_pattern=2,
                         max_seq_len=256)
GEMMA_FIXTURE_PROMPT, GEMMA_FIXTURE_STEPS = 96, 16


def to_device(tree, device):
    """A parameter tree copied to ``device`` (quantized and LoRA leaves too)."""
    import dataclasses

    from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, q=tree.q.to(device), scales=tree.scales.to(device))
    if isinstance(tree, LoraLinear):
        return dataclasses.replace(tree, base=to_device(tree.base, device),
                                   a=tree.a.to(device), b=tree.b.to(device))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_gemma_fixture(sm: Smoke):
    """Gemma-3-1B W8A8, bf16, cut as GEMMA_FIXTURE_CUT: the card against the
    CPU's plain path on the same params (made on the CPU, copied). A random
    96-token prompt, then each of 16 steps' logits (a prefill and 15 decode
    steps fed the CPU's greedy tokens, int8 KV) within ``check_logits``'s
    limit; greedy ids of both printed."""
    torch = sm.torch
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, cpu_params = make_gemma(sm, "cpu", **GEMMA_FIXTURE_CUT)
    card_params = to_device(cpu_params, torch.device("cuda"))
    gen = torch.Generator()
    gen.manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, GEMMA_FIXTURE_PROMPT), generator=gen)
    forced = generate(cpu_params, cfg, prompt, max_new_tokens=GEMMA_FIXTURE_STEPS,
                      quantized_kv=True)
    want = teacher_forced_logits(cpu_params, cfg, prompt, forced)
    reset_launch_counts()
    got = teacher_forced_logits(card_params, cfg, prompt, forced)
    counts = launch_counts()
    ids = generate(card_params, cfg, prompt, max_new_tokens=GEMMA_FIXTURE_STEPS,
                   quantized_kv=True).cpu()
    share = check_logits(sm, "gemma-fixture logits", got, want)
    print(f"gemma-fixture (Gemma-3-1B widths cut to {cfg.num_layers} layers and window "
          f"{cfg.sliding_window}, pattern {cfg.sliding_window_pattern}; bf16, int8 KV; "
          f"prompt {GEMMA_FIXTURE_PROMPT}, {GEMMA_FIXTURE_STEPS} steps): logits max abs err "
          f"{(got - want).abs().max().item()}, {share:.4f} of the limit; greedy ids card "
          f"{ids[0].tolist()}, CPU {forced[0].tolist()}; card launches {counts}")
    L = cfg.num_layers
    steps = GEMMA_FIXTURE_STEPS - 1
    expected = {**dict.fromkeys(counts, 0), "flash_attention": L,
                "a8_matvec": (4 * L + 1) * steps, "a8_quantize": (4 * L + 1) * steps,
                "decode_attention_update": L * steps}
    sm.expect(counts == expected, f"gemma-fixture: launches {counts} != {expected}")


# -- GPT-2 XL W8A8 at full width ----------------------------------------------

GPT2_LABEL = "gpt2-xl-w8a8"
# openai-community/gpt2-xl config.json: 48 layers of 25 heads of 64 (MHA),
# hidden 1600, intermediate 6400, 1024 learned positions, vocabulary 50257.
GPT2_XL_JSON = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "n_embd": 1600,
                "n_head": 25, "n_layer": 48, "n_positions": 1024, "n_ctx": 1024,
                "vocab_size": 50257, "layer_norm_epsilon": 1e-5,
                "activation_function": "gelu_new", "bos_token_id": 50256,
                "eos_token_id": 50256}
# Row 1 at GPT-2 XL's decode shapes, int8, no norm prologue (layernorm runs
# outside the kernel); lm_head at the odd vocabulary (quantize_lm_head=True:
# the last 16-row tile holds one live row).
A8_GPT2 = [("wqkv", 4800, 1600, 8, False), ("wo", 1600, 1600, 8, False),
           ("w1", 6400, 1600, 8, False), ("w2", 1600, 6400, 8, False),
           ("lm_head", 50257, 1600, 8, False)]
# Rows 3 and 5 at 25 heads over 25 kv heads (groups 1): lengths that are not
# multiples of 32 or 64 (the prompt and its decode, the serve mix's), chunk
# edges, the full context, a zeroed cache.
DECODE_CASES_GPT2 = [([1], None, "random"), ([C + 1], None, "random"),
                     ([513], None, "random"), ([545], None, "random"),
                     ([576], None, "random"), ([1024], None, "random"),
                     ([577], None, "zeros")]
READ_CASES_GPT2 = [([513], None), ([545], None), ([577], None)]
READ_CASES_GPT2_SERVE = [([49, 213, 577, 1024, 700, 129, 1, 640], None),
                         ([736, 97, 1, 300, 545, 1000, 65, 33], None)]
# Row 4: the 512-token prompt from 0 and from an unaligned start, the serve
# path's 256-token chunks of 8 rows at per-row offsets, a ragged chunk.
FLASH_CASES_GPT2 = [(0, None), (100, None)]
FLASH_CASES_GPT2_SERVE = [([0, 256, 512, 768, 100, 37, 640, 0], None)]
# Row 8: the serve path's 8 rows on pages of 256 (4 a row).
PAGED_CASES_GPT2 = [([49, 256, 257, 1024, 700, 513, 213, 1], None),
                    ([1024, 300, 545, 1, 97, 900, 640, 1], None)]


def gpt2_kernel_checks(sm: Smoke, gen, dev):
    """Rows 1, 3, 4, 5 and 8 at GPT-2 XL's shapes (25 heads of 64, groups 1;
    K 1600 and 6400; out 50257)."""
    torch = sm.torch
    for rows in (1, 8):
        check_a8(sm, A8_GPT2, rows, gen, dev)
    check_decode(sm, 1, 25, 25, 1024, 64, DECODE_CASES_GPT2, gen, dev)
    check_decode_read(sm, 1, 25, 25, 1024, 64, READ_CASES_GPT2, gen, dev)
    check_decode_read(sm, 8, 25, 25, 1024, 64, READ_CASES_GPT2_SERVE, gen, dev)
    check_flash(sm, 1, 512, 25, 25, 1024, 64, FLASH_CASES_GPT2, gen, dev)
    check_flash(sm, 8, 256, 25, 25, 1024, 64, FLASH_CASES_GPT2_SERVE, gen, dev)
    check_flash(sm, 1, FLASH_RAGGED_S, 25, 25, 1024, 64, FLASH_CASES_RAGGED, gen, dev)
    check_paged(sm, 8, 25, 25, 64, 256, 4, PAGED_CASES_GPT2, gen, dev)
    check_paged(sm, 8, 25, 25, 64, 256, 4, PAGED_CASES_GPT2[:1], gen, dev, torch.float32)


def make_gpt2_params(cfg, device, seed: int = 0):
    """GPT-2 W8A8 per-channel (the scheme of ``prompt --quantize w8a8``),
    wqkv fused, drawn on ``device`` from a seeded torch.Generator in the
    layout `quantize_params` and `fuse_projections` give (tests hold it at
    a small size): int8 codes in [-127, 127] ``q [L, out, in]`` transposed,
    f32 scales ``[L, 1, out]`` in [1.4e-4, 4.2e-4) (weights about GPT-2's
    N(0, 0.02)); N(0, 0.02) projection biases, embedding and positions;
    layernorm weights 1 + N(0, 0.1) and biases N(0, 0.1), all non-zero, so
    that a dropped bias or norm term shows; bf16 activations; lm_head a
    contiguous copy of the embedding's transpose. Nothing is quantized on
    the host: `quantize_params` over GPT-2 XL's 1.47 B weights would take
    tens of seconds."""
    import torch

    from metalchat_tpu_torch.models.transformer import make_rope_tables
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    bf16 = torch.bfloat16

    def normal(*shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(bf16)

    def qlin(in_f, out_f):
        q = torch.randint(-127, 128, (L, out_f, in_f), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((L, 1, out_f), generator=gen, device=dev) * 2.8e-4 + 1.4e-4
        return QuantizedTensor(q=q, scales=s, bits=8, group_size=in_f, transposed=True,
                               act_bits=8)

    layers = {
        "attn_norm": normal(L, h, std=0.1, mean=1.0), "attn_norm_b": normal(L, h, std=0.1),
        "ffn_norm": normal(L, h, std=0.1, mean=1.0), "ffn_norm_b": normal(L, h, std=0.1),
        "wqkv": qlin(h, 3 * h), "wqkv_b": normal(L, 3 * h),
        "wo": qlin(h, h), "wo_b": normal(L, h),
        "w1": qlin(h, f), "w1_b": normal(L, f),
        "w2": qlin(f, h), "w2_b": normal(L, h),
    }
    embed = normal(cfg.vocab_size, h)
    return {
        "embed": embed, "pos_emb": normal(cfg.max_seq_len, h), "layers": layers,
        "final_norm": normal(h, std=0.1, mean=1.0), "final_norm_b": normal(h, std=0.1),
        "lm_head": embed.T.contiguous(),
        "rope": make_rope_tables(cfg, cfg.max_seq_len, device=dev),
    }


def gpt2_generate_counts(cfg, new: int, attn: str):
    """Launches of a `generate` run of GPT-2 of ``new`` decode steps: 4
    matvec calls a layer (lm_head is a dense product), one attention launch
    a layer a step, flash once a layer for the prompt."""
    L = cfg.num_layers
    return {"a8_matvec": 4 * L * new, "a8_quantize": 4 * L * new, attn: L * new,
            "flash_attention": L}


def phase_gpt2(sm: Smoke, dev_name: str):
    """GPT-2 XL W8A8 (all 48 layers, int8 KV, context 1024) through
    `generate`: a 512-token prompt and 64 greedy tokens, launches exact (192
    a8_matvec and 48 decode_attention_update a step, 48 flash a prefill), the
    graph route equal to the eager loop and both timed in turns, its
    profile; then the same `generate` on its default dense bf16 cache (row 5
    in place of row 3), ids and cache equal to the eager loop's."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = config_from_dict(GPT2_XL_JSON)
    t0 = time.perf_counter()
    params = make_gpt2_params(cfg, "cuda")
    torch.cuda.synchronize()
    lm = params["lm_head"]
    print(f"{GPT2_LABEL} params ({cfg.num_layers} layers, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}): {weight_bytes(params) / 1e9:.4f} GB of "
          f"weights ({lm.numel() * lm.element_size() / 1e9:.4f} GB of them the bf16 lm_head), "
          f"made in {time.perf_counter() - t0:.1f} s")
    L = cfg.num_layers
    run = drive_generate(sm, dev_name, GPT2_LABEL, cfg, params,
                         {"a8_matvec": 4 * L, "a8_quantize": 4 * L,
                          "decode_attention_update": L})
    phase_profile(sm, run, GPT2_LABEL)
    prompt, new = run[5], 64
    reset_launch_counts()
    out = generate(params, cfg, prompt, max_new_tokens=new + 1)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), **gpt2_generate_counts(cfg, new, "decode_attention")}
    sm.expect(counts == want, f"{GPT2_LABEL} bf16 cache: launches {counts} != {want}")
    limit = prompt.shape[1] + new + 1
    cache = KVCache.create(cfg, 1, limit, dtype=torch.bfloat16, device=prompt.device)
    ids, _ = eager_generate(params, cfg, prompt, new + 1, cache)
    sm.exact(out, ids, f"{GPT2_LABEL} bf16 cache: graph route ids against the eager loop")
    print(f"{GPT2_LABEL} on generate's default dense bf16 cache ({limit} positions): ids "
          f"equal to the eager loop's; launches {counts}")
    return run, counts


# The correctness cell: GPT-2 at hd 64 cut to 2 layers (hidden 256, 4 heads,
# vocab 512, 256 positions); non-zero biases, layernorm terms and positions.
GPT2_FIXTURE_JSON = dict(GPT2_XL_JSON, n_embd=256, n_head=4, n_layer=2, n_positions=256,
                         vocab_size=512, bos_token_id=511, eos_token_id=511)
GPT2_FIXTURE_PROMPT, GPT2_FIXTURE_STEPS = 96, 16
# The modes: (dtype, quantize_params' arguments or None, fuse).
GPT2_FIXTURE_MODES = {
    "f32": ("float32", None),
    "w8a8 bf16": ("bfloat16", W8A8),
    "w8 g32 embed bf16": ("bfloat16", dict(bits=8, group_size=32, quantize_embed=True)),
    "w4 g32 embed bf16": ("bfloat16", dict(bits=4, group_size=32, quantize_embed=True)),
}


def gpt2_fixture_params(torch, cfg, dtype, quant):
    """The fixture cell's parameters on the CPU: `init_random_params` in f32
    (seed 0) with every bias, layernorm term and the position table redrawn
    non-zero from a seeded generator, then cast to ``dtype``, quantized by
    ``quant`` and fused."""
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.quant.quantize import quantize_params

    params = init_random_params(cfg, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for tree in (params["layers"], params):
        for name, leaf in tree.items():
            if name.endswith("_b") or name.endswith("norm") or name == "pos_emb":
                noise = torch.randn(leaf.shape, generator=gen) * 0.1
                tree[name] = leaf + noise if name.endswith("norm") else noise
    params = {k: (v if k in ("layers", "rope") else v.to(dtype)) for k, v in params.items()}
    params["layers"] = {k: v.to(dtype) for k, v in params["layers"].items()}
    params["lm_head"] = params["embed"].T.contiguous()
    if quant is not None:
        params = quantize_params(params, **quant)
    return fuse_projections(params, cfg)


def first_parting(torch, got_ids, want_ids, want_logits):
    """The first step where two greedy rollouts part, and the CPU's top-2
    logit gap there with `check_logits`'s limit at that logit (None if
    they do not part)."""
    parted = (got_ids != want_ids).any(0).nonzero()
    if parted.numel() == 0:
        return None
    i = int(parted[0])
    row = int((got_ids[:, i] != want_ids[:, i]).nonzero()[0])
    top2 = want_logits[i, row].topk(2).values
    limit = (RTOL["bfloat16"] * top2[0].abs()
             + LOGIT_SHARE * want_logits[i, row].abs().max()).item()
    return i, (top2[0] - top2[1]).item(), limit


def gpt2_fixture_counts(cfg, quant, steps: int):
    """Launches of two prefills (flash) and ``steps`` decode steps of the
    fixture cell (int8 KV: row 3): its 4 projections a layer through row 1
    (W8A8) or row 11 (weight-only, at 2 rows), none for dense f32; the
    head is a dense product."""
    L = cfg.num_layers
    counts = {"flash_attention": 2 * L, "decode_attention_update": L * steps}
    if quant is not None and quant.get("act_bits") == 8:
        counts.update(a8_matvec=4 * L * steps, a8_quantize=4 * L * steps)
    elif quant is not None:
        counts.update(quant_matmul=4 * L * steps)
    return counts


def phase_gpt2_fixture(sm: Smoke):
    """GPT-2 cut as GPT2_FIXTURE_JSON in each GPT2_FIXTURE_MODES mode, the
    card against the CPU's plain path on the same params (made on the CPU,
    copied): two random 96-token prompts, 16 greedy tokens through
    `generate` (int8 KV), and each step's logits fed the CPU's tokens within
    `check_logits`'s limit. The ids must agree, or part only where the CPU's
    top-2 gap lies within that limit (a near tie)."""
    torch = sm.torch
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = config_from_dict(GPT2_FIXTURE_JSON)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (2, GPT2_FIXTURE_PROMPT), generator=gen)
    total = {}
    for mode, (dtype, quant) in GPT2_FIXTURE_MODES.items():
        cpu_params = gpt2_fixture_params(torch, cfg, getattr(torch, dtype), quant)
        card_params = to_device(cpu_params, torch.device("cuda"))
        forced = generate(cpu_params, cfg, prompt, max_new_tokens=GPT2_FIXTURE_STEPS,
                          quantized_kv=True)
        want = teacher_forced_logits(cpu_params, cfg, prompt, forced)
        reset_launch_counts()
        got = teacher_forced_logits(card_params, cfg, prompt, forced)
        ids = generate(card_params, cfg, prompt, max_new_tokens=GPT2_FIXTURE_STEPS,
                       quantized_kv=True).cpu()
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        share = check_logits(sm, f"gpt2-fixture {mode} logits", got, want)
        parting = first_parting(torch, ids, forced, want)
        if parting is not None:
            i, gap, limit = parting
            sm.expect(gap <= limit, f"gpt2-fixture {mode}: ids part at step {i} with a "
                      f"top-2 gap of {gap} on the CPU, beyond the limit {limit}")
        print(f"gpt2-fixture {mode} ({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
              f"{cfg.num_heads} heads of {cfg.head_dim}; int8 KV; 2 prompts of "
              f"{GPT2_FIXTURE_PROMPT}, {GPT2_FIXTURE_STEPS} steps): logits max abs err "
              f"{(got - want).abs().max().item():.4g}, {share:.4f} of the limit; ids "
              + ("equal" if parting is None else
                 f"part at step {parting[0]}, a near tie (gap {parting[1]:.4g}, limit "
                 f"{parting[2]:.4g})")
              + f"; card launches {counts}", flush=True)
        expected = {**dict.fromkeys(counts, 0),
                    **gpt2_fixture_counts(cfg, quant, 2 * (GPT2_FIXTURE_STEPS - 1))}
        sm.expect(counts == expected, f"gpt2-fixture {mode}: launches {counts} != {expected}")
    return total


# Perplexity of the fixture (pyllama_10m) in bf16 against its quantized
# trees, over PPL_BATCHES batches of PPL_ROWS rows of PPL_LEN eval tokens.
PPL_BATCHES, PPL_ROWS, PPL_LEN = 4, 4, 128
# The calibrated modes' batch: the quality gate's shape, 8 rows of PPL_LEN
# (tools/quality_gate.py:67), the eval tokens after the scored ones.
PPL_CALIB_ROWS = 8
# AWQ's α: the one the quality gate's grid picks at these sizes (phase
# quality on an NVIDIA H100, PR 26: calibration NLL 1.2889 at 0.2, 1.2989 at
# 0.1), fixed here so card and CPU fold alike and phase quality reuses these
# trees' CPU perplexities.
PPL_AWQ_ALPHA = 0.2
# A mode is `quantize_params` keywords (quantized once on the host: the
# same bytes for card and CPU), or a calibrated scheme quantized once on the
# card and once on the CPU: {"awq": α} (`awq_quantize_params`) or {"gptq":
# keywords} (W4A8 `gptq_quantize_params`). A calibrated mode's codes are
# held card against CPU within GPTQ_TOLERANCE's share (`codes_against_cpu`):
# the perplexities alone cannot tell GPTQ from GPTQ refit or AWQ + GPTQ.
PPL_MODES = {
    "w8a8": W8A8,
    "w4a8": dict(bits=4, group_size=None, act_bits=8),
    "int4 g32": dict(bits=4, group_size=32),
    "int4 g32 clip_search": dict(bits=4, group_size=32, clip_search=True),
    "int8 g32 quantize_embed": dict(bits=8, group_size=32, quantize_embed=True),
    "w4a8 clip_search": dict(bits=4, group_size=None, act_bits=8, clip_search=True),
    "w4a8 awq": {"awq": PPL_AWQ_ALPHA},
    "w4a8 gptq": {"gptq": {}},
    "w4a8 gptq refit": {"gptq": dict(refit_iters=2)},
    "w4a8 awq gptq": {"gptq": dict(awq_alpha=PPL_AWQ_ALPHA)},
}
# Card against CPU: each perplexity within this share of the CPU's (bf16
# logits on both; the NLL averages PPL_BATCHES * PPL_ROWS * (PPL_LEN - 1)
# tokens, so a rounding step here and there moves it far less).
PPL_RTOL = 5e-3
# GPTQ codes of one leaf against another build's on the same weights and
# Hessian (the card against the CPU; the port against JAX in the CPU tests):
# at most this share of the codes differ, each by one quantum, and the
# per-channel Hessian objective summed over channels within this relative
# difference. The recursion's arithmetic is the same on every device, but
# inv/cholesky differ in the last ulp between LAPACK builds, calibration's f32
# products sum in another order, and a code that flips at a .5 boundary feeds
# another error into the channels after it. Trees calibrated apart, and the
# fixture's trained Hessians factored apart (phase ppl), are held to the
# share alone.
GPTQ_TOLERANCE = (0.02, 0.01)


def codes_against_cpu(sm: Smoke, what: str, card_tree, cpu_tree):
    """Every per-channel layer leaf of a tree quantized on the card against
    the same tree quantized on the CPU, each side calibrated on its own: at
    most GPTQ_TOLERANCE's share of the codes differ. The one-quantum bound
    holds only on shared inputs and random weights (`gptq_against_cpu`):
    here the Hessians and their factorizations differ in their last bits,
    and a flipped code feeds another error into the channels after it.
    Returns (share, largest difference)."""
    torch = sm.torch
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor

    n = diff = worst = 0
    for name, leaf in cpu_tree["layers"].items():
        if not isinstance(leaf, QuantizedTensor):
            continue
        for l in range(leaf.q.shape[0]):
            d = (unpack_codes(card_tree["layers"][name], l).cpu().to(torch.int32)
                 - unpack_codes(leaf, l).to(torch.int32))
            n, diff = n + d.numel(), diff + int((d != 0).sum())
            worst = max(worst, int(d.abs().max()))
    share = diff / n
    sm.expect(share <= GPTQ_TOLERANCE[0], f"{what}: {diff} of {n} codes differ card "
              f"against CPU, the largest by {worst}")
    return share, worst


def gptq_cause(sm: Smoke, cfg, card_ref, ref, calib, card_tree) -> str:
    """Where the fixture's GPTQ codes (no refit) part between card and CPU:
    each tap's Hessians, card against CPU (largest difference over the
    largest entry), and the CPU's recursion run on the card's Hessians,
    whose codes against the card's own are the factorization's share (the
    damping's mean, inv and cholesky): at most GPTQ_TOLERANCE's share. On
    the fixture's trained Hessians a flip there moves later codes by more
    than one quantum, so the largest difference is reported, not bound."""
    torch = sm.torch
    from metalchat_tpu_torch.quant import gptq
    from metalchat_tpu_torch.quant.awq import calibration_stats

    h_card = calibration_stats(card_ref, cfg, calib.cuda(), tap=gptq.hessian_tap)
    h_cpu = calibration_stats(ref, cfg, calib, tap=gptq.hessian_tap)
    layers, parts, n, diff, worst = ref["layers"], [], 0, 0, 0
    for tap, H in h_cpu.items():
        names = [k for k, t in gptq._TAP_OF.items() if t == tap and k in layers]
        hc = h_card[tap].cpu()
        parts.append(f"{tap} {float((hc - H).abs().max() / H.abs().max()):.3g}")
        w = torch.cat([layers[k].float() for k in names], dim=-1).double()
        q, _ = gptq._gptq_codes(w, hc, qmax=7.0, clip_search=True, act_order=True,
                                damp=0.01, refit_iters=0, failures=None)
        card = torch.cat([torch.stack([unpack_codes(card_tree["layers"][k], l)
                                       for l in range(cfg.num_layers)]) for k in names], dim=-1)
        d = card.cpu().to(torch.int32) - q.to(torch.int32)
        n, diff = n + q.numel(), diff + int((d != 0).sum())
        worst = max(worst, int(d.abs().max()))
    sm.expect(diff <= GPTQ_TOLERANCE[0] * n, f"ppl gptq: {diff} of {n} codes differ on the "
              f"card's Hessians, the largest by {worst}")
    return (f"Hessians card against CPU (largest difference / largest entry): "
            f"{', '.join(parts)}; the CPU recursion on the card's Hessians: {diff} of {n} "
            f"codes differ from the card's (largest {worst})")


def ppl_candidate(quant: dict, params, cfg, calib):
    """A PPL_MODES tree of ``params`` (calibrated on ``calib`` where the mode
    calibrates)."""
    from metalchat_tpu_torch.quant.awq import awq_quantize_params
    from metalchat_tpu_torch.quant.gptq import gptq_quantize_params
    from metalchat_tpu_torch.quant.quantize import quantize_params

    if "awq" in quant:
        return awq_quantize_params(params, cfg, calib, alpha=quant["awq"])
    if "gptq" in quant:
        return gptq_quantize_params(params, cfg, calib, bits=4, act_bits=8, **quant["gptq"])
    return quantize_params(params, **quant)


def phase_ppl(sm: Smoke):
    """`perplexity_delta` of the fixture's bf16 tree against each PPL_MODES
    tree, on the card and on the CPU's plain path: every perplexity within
    PPL_RTOL of the CPU's; the table printed. On the card `forward` runs the
    prefill's flash attention (a batch is longer than 16 tokens). The
    calibrated modes (AWQ, GPTQ) quantize on the card and on the CPU from
    the same bf16 weights and calibration tokens, their codes held card
    against CPU (`codes_against_cpu`), plain GPTQ's traced to the Hessians
    or the factorization (`gptq_cause`)."""
    torch = sm.torch
    from pathlib import Path

    import numpy as np

    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.ppl import perplexity_delta, token_nll

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    cfg = load_config(fixture / "config.json")
    tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
    n = PPL_ROWS * PPL_LEN
    batches = [tokens[i * n:(i + 1) * n].reshape(PPL_ROWS, PPL_LEN) for i in range(PPL_BATCHES)]
    calib = torch.from_numpy(tokens[PPL_BATCHES * n:PPL_BATCHES * n + PPL_CALIB_ROWS * PPL_LEN]
                             .reshape(PPL_CALIB_ROWS, PPL_LEN))
    ref = load_params(open_safetensors(fixture), cfg, dtype=torch.bfloat16, device="cpu")
    card_ref = to_device(ref, torch.device("cuda"))

    def cpu_perplexity(params):  # perplexity_delta's, one tree on the CPU
        return float(np.exp(np.mean([float(token_nll(params, cfg, torch.from_numpy(b)))
                                     for b in batches])))

    cpu_reference = cpu_perplexity(ref)  # once: the same tree for every mode
    reset_launch_counts()
    table, worst, codes, cause = [], 0.0, {}, None
    cpu_trees, cpu_ppl = {}, {}
    for mode, quant in PPL_MODES.items():
        t0 = time.perf_counter()
        calibrated = "awq" in quant or "gptq" in quant
        if calibrated:
            card_cand = ppl_candidate(quant, card_ref, cfg, calib.cuda())
            torch.cuda.synchronize()
            quant_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cand = ppl_candidate(quant, ref, cfg, calib)
            cpu_quant_s = time.perf_counter() - t0
            codes[mode] = codes_against_cpu(sm, f"ppl {mode}", card_cand, cand)
            if quant == {"gptq": {}}:
                cause = gptq_cause(sm, cfg, card_ref, ref, calib, card_cand)
        else:
            cand = ppl_candidate(quant, ref, cfg, None)
            card_cand = to_device(cand, torch.device("cuda"))
            quant_s = cpu_quant_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = perplexity_delta(card_ref, card_cand, cfg, batches)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_cand = cpu_perplexity(cand)
        cpu_s = time.perf_counter() - t0
        cpu_trees[mode], cpu_ppl[mode] = cand, cpu_cand
        want = {"reference": cpu_reference, "candidate": cpu_cand,
                "delta_pct": 100.0 * (cpu_cand - cpu_reference) / cpu_reference}
        for key in ("reference", "candidate"):
            rel = abs(got[key] - want[key]) / want[key]
            worst = max(worst, rel)
            sm.expect(rel <= PPL_RTOL, f"ppl {mode}: {key} {got[key]} on the card against "
                      f"{want[key]} on the CPU ({rel:.3g} relative)")
        table.append((mode, got, want, card_s, cpu_s, quant_s, cpu_quant_s))
    counts = launch_counts()
    print(f"ppl: the fixture in bf16 against each tree, {PPL_BATCHES} batches of "
          f"{PPL_ROWS} x {PPL_LEN} eval tokens (card, then CPU; worst card/CPU relative "
          f"difference {worst:.3g}, limit {PPL_RTOL}); calibrated modes on "
          f"{PPL_CALIB_ROWS} x {PPL_LEN} later tokens, AWQ alpha {PPL_AWQ_ALPHA}, their "
          f"codes card against CPU:")
    for mode, got, want, card_s, cpu_s, quant_s, cpu_quant_s in table:
        print(f"  {mode}: reference {got['reference']:.5f} candidate {got['candidate']:.5f} "
              f"delta {got['delta']:.5f} ({got['delta_pct']:.4f}%) in {card_s:.2f} s; CPU "
              f"{want['reference']:.5f} {want['candidate']:.5f} ({want['delta_pct']:.4f}%) in "
              f"{cpu_s:.2f} s; "
              f"quantized in {quant_s:.2f} s (CPU {cpu_quant_s:.2f} s)"
              + (f"; {codes[mode][0]:.6f} of the codes differ (largest {codes[mode][1]} "
                 f"quanta)" if mode in codes else ""))
    print(f"ppl w4a8 gptq, card against CPU: {cause}")
    want = {**dict.fromkeys(counts, 0),
            "flash_attention": 2 * len(PPL_MODES) * PPL_BATCHES * cfg.num_layers}
    sm.expect(counts == want, f"ppl: launches {counts} != {want}")
    print(f"ppl launches {counts}")
    return {"counts": counts, "cfg": cfg, "ref": ref, "reference": cpu_reference,
            "trees": cpu_trees, "ppl": cpu_ppl, "batches": batches, "calib": calib}


# The quality gate's schemes that phase ppl scores too (its mode names), the
# AWQ ones only where the gate's α search picks PPL_AWQ_ALPHA.
GATE_PPL_MODES = {"int4_g32": "int4 g32", "int4_g32_clip": "int4 g32 clip_search",
                  "w8a8": "w8a8", "w4a8": "w4a8", "w4a8_clip": "w4a8 clip_search",
                  "w4a8_awq": "w4a8 awq", "w4a8_gptq": "w4a8 gptq",
                  "w4a8_gptq_refit": "w4a8 gptq refit", "w4a8_awq_gptq": "w4a8 awq gptq"}


def phase_quality(sm: Smoke, ppl):
    """The port's quality gate (`tools.quality_gate.run_gate`) on the card at
    ``--batches 4 --batch 4 --seq 128`` in bf16: the same eval batches and
    calibration rows as phase ppl (checked equal), the AWQ α searched, the
    three GPTQ trees, the twelve schemes, the long-context tiebreak over
    4 x 4 x 1024 later tokens, ``headline_int8kv``. Every scheme's
    perplexity within PPL_RTOL of the CPU's: phase ppl's CPU number where
    the two share the scheme, else computed here on the CPU from phase
    ppl's CPU trees (int8 g32 without the row-quantized embedding, the
    int8-KV rows, AWQ at another α). Prints the table, α, the headline,
    the record and the seconds."""
    torch = sm.torch
    from pathlib import Path

    import numpy as np

    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.awq import awq_quantize_params
    from metalchat_tpu_torch.quant.gptq import gptq_quantize_params
    from metalchat_tpu_torch.quant.quantize import quantize_params
    from metalchat_tpu_torch.tools import quality_gate as qg

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    t0 = time.perf_counter()
    params, cfg, ev, long_seq = qg.load_fixture(fixture, PPL_LEN, torch.device("cuda"))
    cut = qg.slices(ev, PPL_BATCHES, PPL_ROWS, PPL_LEN, long_seq)
    sm.expect(np.array_equal(cut.data, np.stack(ppl["batches"]))
              and np.array_equal(cut.calib, ppl["calib"].numpy()),
              "quality: the gate's eval batches or calibration rows differ from phase ppl's")
    reset_launch_counts()
    logs = []
    gate = qg.run_gate(params, cfg, cut, log=logs.append)
    torch.cuda.synchronize()
    counts = launch_counts()
    card_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref, calib, trees = ppl["ref"], ppl["calib"], dict(ppl["trees"])
    if gate.awq_alpha != PPL_AWQ_ALPHA:  # phase ppl's AWQ trees are at another α
        trees["w4a8 awq"] = awq_quantize_params(ref, cfg, calib, alpha=gate.awq_alpha)
        trees["w4a8 awq gptq"] = gptq_quantize_params(ref, cfg, calib, bits=4, act_bits=8,
                                                      awq_alpha=gate.awq_alpha)
    cpu_tree = {name: trees[mode] for name, mode in GATE_PPL_MODES.items()}
    cpu_tree["bf16"] = ref
    cpu_tree["int8_g32"] = quantize_params(ref, bits=8, group_size=32)
    cpu_tree["w4a8_awq_int8kv"] = cpu_tree["w4a8_awq"]
    cpu_tree["headline_int8kv"] = cpu_tree[gate.headline]
    rows, worst = [], 0.0
    for name, (_, qkv) in gate.schemes.items():
        shared = name == "bf16" or (name in GATE_PPL_MODES and (
            gate.awq_alpha == PPL_AWQ_ALPHA or "awq" not in name))
        if not shared:
            want = qg.perplexity_over(cpu_tree[name], cfg, cut.data, qkv)
        else:
            want = ppl["reference"] if name == "bf16" else ppl["ppl"][GATE_PPL_MODES[name]]
        got = gate.results[name]
        rel = abs(got - want) / want
        worst = max(worst, rel)
        rows.append((name, got, want, rel, "phase ppl" if shared else "here"))
        sm.expect(rel <= PPL_RTOL, f"quality {name}: ppl {got} on the card against {want} "
                  f"on the CPU ({rel:.3g} relative)")
    cpu_s = time.perf_counter() - t0
    sm.expect(counts["flash_attention"] > 0, f"quality: launches {counts}")
    print(f"quality: the port's gate (tools/quality_gate.py) on the card, {PPL_BATCHES} "
          f"batches of {PPL_ROWS} x {PPL_LEN} (phase ppl's), bf16; AWQ alpha "
          f"{gate.awq_alpha} (calibration NLL {gate.alpha_nll}); headline {gate.headline}; "
          f"worst card/CPU relative difference {worst:.3g} (limit {PPL_RTOL}); card "
          f"{card_s:.2f} s, CPU {cpu_s:.2f} s; launches {counts}", flush=True)
    for name, got, want, rel, where in rows:
        print(f"  {name}: card {got:.5f} ({gate.deltas[name]:+.4f}%) CPU {want:.5f} "
              f"({rel:.3g} apart; CPU number from {where})")
    print(f"quality record: {json.dumps(qg.record(gate, 'tests/fixtures/pyllama_10m'))}",
          flush=True)
    return counts


# -- quantization tooling at Llama-3.2-1B's widths (qlora-1b, gptq-1b) ----------

QLORA_LABEL = "qlora-1b"
GPTQ_LABEL = "gptq-1b-w4a8"
QLORA_RANK = 16
# Reference-dialect codes are uniform over ±127 (std 73): scales of about
# this size give weights of std ~0.02, as `init_random_params` draws them.
QLORA_SCALE = 2.7e-4
# The gate's calibration shape (tools/quality_gate.py:67): 8 rows of 512.
GPTQ_CALIB = (8, 512)
# gptq-1b folds AWQ's saliency scales first, with this α (awq_fold's
# default): `gptq_quantize_params(awq_alpha=...)` on the card.
GPTQ_AWQ_ALPHA = 0.5
# The card's GPTQ codes against the CPU port's: layer 0's leaves, the first
# this many output columns of each (each column's recursion is its own; w2's
# 8192 channels make its CPU side the costly one: 15.9 s at 64 columns on the
# H100 machine's host, so 32).
GPTQ_COMPARE = {"wk": 256, "wo": 256, "w1": 256, "w2": 32}
# gptq-1b runs Llama-3.2-1B's widths cut to its first 4 of 16 layers (GPTQ
# took 68.8 s at full depth on an NVIDIA H100 80GB HBM3 at 700 W, about 4.3 s
# a layer; 8 layers until the tp-leaves phase was added), so that the
# script, with its train and parallel phases, stays inside its time limit.
GPTQ_LAYERS = 4
# Greedy steps compared bit for bit after a native export and reload.
ROUNDTRIP_STEPS = 16


def write_reference_qlora(path, cfg, rank: int = QLORA_RANK, seed: int = 0,
                          device="cuda", group: int = 32) -> int:
    """A QLoRA checkpoint in the reference's internal naming at ``cfg``'s
    widths, drawn from a seeded torch.Generator on ``device``: int8 ``[out,
    in]`` codes with f32 ``[out, in/group]`` scales, adaptors ``A [rank,
    in]`` and ``B [out, rank]`` and norms in bf16, the embedding int8 with
    its scales, and no ``output.weight`` (the head tied to the embedding).
    Returns the file's size in bytes."""
    import torch

    from metalchat_tpu_torch.io.safetensors import save_safetensors

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    H, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def codes(o, i):
        return torch.randint(-127, 128, (o, i), generator=gen, device=device, dtype=torch.int8)

    def scales(o, i):
        return (torch.rand((o, i // group), generator=gen, device=device) + 0.5) * QLORA_SCALE

    def normal(*shape, std=0.02, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device=device)).to(torch.bfloat16)

    dims = {"attention.wq": (nh * hd, H), "attention.wk": (nkv * hd, H),
            "attention.wv": (nkv * hd, H), "attention.wo": (H, nh * hd),
            "feed_forward.w1": (F, H), "feed_forward.w2": (H, F), "feed_forward.w3": (F, H)}
    tensors = {}
    for i in range(L):
        for name, (o, inn) in dims.items():
            p = f"layers.{i}.{name}"
            tensors[p + ".weight"], tensors[p + ".scales"] = codes(o, inn), scales(o, inn)
            tensors[p + ".adaptor.A.weight"] = normal(rank, inn)
            tensors[p + ".adaptor.B.weight"] = normal(o, rank)
        tensors[f"layers.{i}.attention_norm.weight"] = normal(H, std=0.1, mean=1.0)
        tensors[f"layers.{i}.ffn_norm.weight"] = normal(H, std=0.1, mean=1.0)
    tensors["tok_embeddings.weight"] = codes(cfg.vocab_size, H)
    tensors["tok_embeddings.scales"] = scales(cfg.vocab_size, H)
    tensors["norm.weight"] = normal(H, std=0.1, mean=1.0)
    save_safetensors(path, tensors)
    return sum(t.numel() * t.element_size() for t in tensors.values())


def sync(torch, device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def same_layout(tree, like):
    """``tree`` with every leaf stored as in ``like``: a quantized leaf in
    ``like``'s orientation, a dense one with its strides (the values
    unchanged)."""
    import dataclasses

    import torch

    from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor, with_orientation

    if isinstance(like, QuantizedTensor):
        return with_orientation(tree, like.transposed)
    if isinstance(like, LoraLinear):
        return dataclasses.replace(tree, base=same_layout(tree.base, like.base))
    if isinstance(like, dict):
        return {k: same_layout(tree[k], v) for k, v in like.items()}
    if tree.stride() == like.stride():
        return tree
    return torch.empty_strided(like.shape, like.stride(), dtype=tree.dtype,
                               device=tree.device).copy_(tree)


def native_roundtrip(sm: Smoke, label: str, cfg, params, path):
    """`export_quantized` → `save_safetensors` → `load_quantized` on the
    parameters' device: every tensor the two trees export equal, bit for bit (the leaves
    in the canonical layout). Returns the reloaded tree."""
    torch = sm.torch
    from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
    from metalchat_tpu_torch.quant.checkpoint import export_quantized, load_quantized

    dev = params["final_norm"].device
    sync(torch, dev)
    t = time.perf_counter()
    tensors, meta = export_quantized(params, cfg)
    save_safetensors(path, tensors, meta)
    export_s = time.perf_counter() - t
    del tensors
    t = time.perf_counter()
    reloaded = load_quantized(open_safetensors(path), cfg, device=dev,
                              dtype=params["final_norm"].dtype,
                              max_seq_len=params["rope"]["cos"].shape[0])
    sync(torch, dev)
    load_s = time.perf_counter() - t
    want, want_meta = export_quantized(params, cfg)
    got, got_meta = export_quantized(reloaded, cfg)
    sm.expect(got_meta == want_meta and sorted(got) == sorted(want),
              f"{label}: the reloaded tree exports {got_meta} against {want_meta}")
    for name, t_ in want.items():
        sm.expect(got[name].dtype == t_.dtype, f"{label}: {name} {got[name].dtype} after "
                  f"the round trip, {t_.dtype} before")
        sm.exact(got[name], t_, f"{label}: {name} after export, save and load")
    print(f"{label}: export + save {export_s:.2f} s ({path.stat().st_size / 1e9:.4f} GB, "
          f"metadata {meta}), load_quantized {load_s:.2f} s; {len(want)} tensors equal "
          "after the round trip")
    return reloaded, export_s, load_s


def roundtrip_logits(sm: Smoke, label: str, cfg, params, reloaded, prompt):
    """The reloaded tree against the tree it was saved from, ROUNDTRIP_STEPS
    greedy steps after ``prompt`` on an int8 cache: stored as the original
    (`same_layout`) its ids and every step's logits equal, bit for bit; as
    `load_quantized` stores it (`auto_orient` may turn a leaf, which moves
    that leaf to the other kernel schedule) its logits fed the same ids
    within `check_logits`'s limit."""
    from metalchat_tpu_torch.cache import QuantizedKVCache

    cache = QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device=prompt.device)
    ids, _ = eager_generate(params, cfg, prompt, ROUNDTRIP_STEPS, cache)
    want = teacher_forced_logits(params, cfg, prompt, ids)
    got = teacher_forced_logits(same_layout(reloaded, params), cfg, prompt, ids)
    sm.exact(got, want, f"{label}: logits of the reloaded tree stored as the original")
    sm.exact(got.argmax(-1).T, ids.cpu(), f"{label}: greedy ids of the reloaded tree")
    turned = [k for k, v in params["layers"].items() if getattr(
        getattr(v, "base", v), "transposed", None) != getattr(
        getattr(reloaded["layers"][k], "base", reloaded["layers"][k]), "transposed", None)]
    head_turned = getattr(params["lm_head"], "transposed", None) != getattr(
        reloaded["lm_head"], "transposed", None)
    share = check_logits(sm, f"{label}: reloaded tree as loaded",
                         teacher_forced_logits(reloaded, cfg, prompt, ids), want)
    print(f"{label}: after the round trip {ROUNDTRIP_STEPS} greedy ids and each step's logits "
          f"equal bit for bit (stored as the original); as loaded (turned by auto_orient: "
          f"{turned + ['lm_head'] * head_turned or 'none'}) the logits within "
          f"{share:.3g} of check_logits's limit")


def phase_qlora_1b(sm: Smoke, dev_name: str):
    """qlora-1b: a reference-dialect QLoRA checkpoint at Llama-3.2-1B's
    widths (int8 group 32, f32 scales, rank-16 adaptors, the head tied to the
    embedding; about 1.4 GB, written to a temporary directory and deleted)
    → `load_reference_qlora` onto the card → `generate` (`drive_generate`:
    512-token prompt, 64 greedy steps, int8 KV, context 1024, the graph
    route against the eager loop bit for bit; 113 row-11 and 16 row-3
    launches a step, 16 flash a prefill, nothing else), its profile (the
    busy share; the prefill dequantizes every int8 base in bf16), then
    `export_quantized` → save → `load_quantized` (`native_roundtrip`,
    `roundtrip_logits`)."""
    torch = sm.torch
    import shutil
    import tempfile
    from pathlib import Path

    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.quant.checkpoint import load_reference_qlora

    cfg = config_from_dict(LLAMA32_1B_CONFIG).replace(max_seq_len=1024)
    L = cfg.num_layers
    tmp = Path(tempfile.mkdtemp(prefix="metalchat_qlora_"))
    try:
        t = time.perf_counter()
        nbytes = write_reference_qlora(tmp / "qlora.safetensors", cfg)
        write_s = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params = load_reference_qlora(open_safetensors(tmp / "qlora.safetensors"), cfg,
                                      device="cuda", max_seq_len=1024)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        print(f"{QLORA_LABEL}: reference QLoRA checkpoint, {nbytes / 1e9:.4f} GB of tensors "
              f"(rank {QLORA_RANK}, int8 g32, f32 scales, tied head) written in {write_s:.2f} s; "
              f"load_reference_qlora onto the card {load_s:.2f} s; "
              f"{weight_bytes(params) / 1e9:.4f} GB read a decode step", flush=True)
        run = drive_generate(sm, dev_name, QLORA_LABEL, cfg, params,
                             {"quant_matmul": 7 * L + 1, "decode_attention_update": L})
        phase_profile(sm, run, QLORA_LABEL)
        reloaded, _, _ = native_roundtrip(sm, QLORA_LABEL, cfg, params, tmp / "native.safetensors")
        roundtrip_logits(sm, QLORA_LABEL, cfg, params, reloaded, run[5])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return run


TRAIN_LABEL = "qlora-1b-train"
# phase `train`: 8 Adam steps (lr 2e-3, remat) on one fixed batch of 4 rows
# of 512 inputs (2048 label positions), drawn from a generator of its own.
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = 8
TRAIN_LR = 2e-3
TRAIN_SEED = 18
# The first step held card against CPU on a cut of the tree: layers, rows,
# inputs. Both sides run bf16 activations, each product and sum rounded to
# bf16 (2^-9 relative) in another order: on the CPU at hidden 1024 the bf16
# adaptor gradients stood 1.4-1.8% (relative L2, per leaf) from f32 ones and
# the loss 6e-5 from f32's, so card against CPU, two such roundings, is held
# to 5% and 1e-3: a wrong or transposed gradient is 100% or more away.
TRAIN_CHECK = (2, 2, 64)
TRAIN_GRAD_RTOL = 0.05
TRAIN_LOSS_RTOL = 1e-3
# train-fixture: card against CPU, losses within FIXTURE_LOSS_RTOL: f32 on
# both sides, but the loss rounds k and v to a bf16 cache and the softmax
# weights to bf16 (the JAX package's route), so the ulps by which the
# card's f32 sums differ from the CPU's flip some of those roundings, each
# a jump of 2^-9 of its value (measured: 6.3e-5 on the first loss, on the
# same parameters, and 2.7e-4 at most over 5 steps). The leaves: L1 within
# 1% of their movement, as in tests/test_torch_train.py.
FIXTURE_LOSS_RTOL = 1e-3
# train-fixture: the trained fixture fine-tuned whole in f32 (AdamW with
# optax's defaults: betas 0.9/0.999, eps 1e-8, weight decay 1e-4; lr 1e-4,
# at which the trained fixture's loss stays near its 0.93: at 1e-3 it climbs
# to 4 in five steps) on successive windows of eval_tokens.npy: rows,
# inputs, steps.
FIXTURE_TRAIN = (4, 128, 5)
FIXTURE_TRAIN_LR = 1e-4


def first_step_grads(torch, cfg, params, tokens, pred):
    """The loss and the trainable leaves' gradients of one differentiable
    step (remat on) on ``params``."""
    from metalchat_tpu_torch import train as tt

    trainable, frozen, spec = tt.partition(params, pred)
    leaves = [t.detach().clone().requires_grad_(True) for t in trainable]
    with torch.enable_grad():
        loss = tt.causal_lm_loss(tt.combine(leaves, frozen, spec), tokens,
                                 torch.ones(tokens.shape[0], tokens.shape[1] - 1,
                                            device=tokens.device), cfg)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.float().cpu() for g in grads]


TRAIN_SPLIT = ("dequantise", "attention", "loss", "optimizer")


def train_step_split(torch, step_fn, state, frozen, batch):
    """torch.profiler over one more train step: device ms by part. The parts
    are record_function ranges (the step's own "loss" and "optimizer", and
    "dequantise" and "attention" around `dequant_weight` and the reference
    attention, patched here, each run again by the recomputation); a kernel
    counts to the innermost range whose device span holds it, and the rest
    to matmuls (cuBLAS kernels) or other work (norms, rope, casts, adaptor
    epilogues, and the backward's elementwise kernels). Returns the state
    after it."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    quantize = importlib.import_module("metalchat_tpu_torch.quant.quantize")
    reference = importlib.import_module("metalchat_tpu_torch.ops.reference")

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    saved = (quantize.dequant_weight, reference.attention)
    quantize.dequant_weight = ranged("dequantise", saved[0])
    reference.attention = ranged("attention", saved[1])
    dev = state.trainable[0].device
    try:
        sync(torch, dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step_fn(state, frozen, batch)
            sync(torch, dev)
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        quantize.dequant_weight, reference.attention = saved
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if getattr(e, "is_user_annotation", False) and e.name in TRAIN_SPLIT]
    kernels = [e for e in events if not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"{TRAIN_LABEL}: the step's device split not measured (the profiler "
              "recorded no device activity)")
        return state
    split = dict.fromkeys(TRAIN_SPLIT + ("matmuls", "other"), 0.0)
    top = {}
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        inside = [sp for sp in spans if sp[0] <= s and t <= sp[1]]
        if inside:
            part = min(inside, key=lambda sp: sp[1] - sp[0])[2]
        elif "multi_tensor_apply" in e.name:  # the foreach update, launched on no span
            part = "optimizer"
        else:
            low = e.name.lower()
            part = "matmuls" if any(k in low for k in ("gemm", "nvjet", "sm90", "cutlass",
                                                        "xmma", "cublas")) else "other"
        us = e.time_range.elapsed_us()
        split[part] += us
        top[e.name[:60]] = top.get(e.name[:60], 0.0) + us
    busy = sum(split.values())
    print(f"{TRAIN_LABEL}: profiled step (loss {float(m['loss']):.6f}) wall {wall:.3f} ms, "
          f"device {busy / 1e3:.3f} ms in {len(kernels)} kernels; device ms by part: "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in split.items())
          + (" (no range spans recorded: ranges not measured)" if not spans else ""))
    print(f"{TRAIN_LABEL}: top kernels (device ms): " + ", ".join(
        f"{k} {v / 1e3:.3f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:10]))
    return state


def train_check_against_cpu(sm: Smoke, cfg, params, tokens):
    """The first step on a cut of the tree (`TRAIN_CHECK`), card against
    CPU: the loss within TRAIN_LOSS_RTOL, each adaptor gradient within
    TRAIN_GRAD_RTOL (relative L2)."""
    torch = sm.torch
    from metalchat_tpu_torch.train import trainable_lora

    n, rows, s = TRAIN_CHECK
    cut_cfg, cut = first_layers((cfg, params), n, f"{TRAIN_LABEL} check")
    toks = tokens[:rows, :s + 1]
    t0 = time.perf_counter()
    card = first_step_grads(torch, cut_cfg, cut, toks, trainable_lora)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = first_step_grads(torch, cut_cfg, to_device(cut, "cpu"), toks.cpu(), trainable_lora)
    cpu_s = time.perf_counter() - t0
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(card[1], cpu[1])]
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    print(f"{TRAIN_LABEL}: first step on {n} layers, {rows} x {s} inputs, card against CPU: "
          f"loss {card[0]:.6f} / {cpu[0]:.6f} ({loss_rel:.3g} apart, limit "
          f"{TRAIN_LOSS_RTOL}); {len(rel)} adaptor gradients, relative L2 max {max(rel):.4g} "
          f"median {sorted(rel)[len(rel) // 2]:.4g} (limit {TRAIN_GRAD_RTOL}); card "
          f"{card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
    sm.expect(loss_rel <= TRAIN_LOSS_RTOL, f"{TRAIN_LABEL}: first-step loss card {card[0]} "
              f"CPU {cpu[0]}")
    sm.expect(max(rel) <= TRAIN_GRAD_RTOL, f"{TRAIN_LABEL}: adaptor gradients card against "
              f"CPU {rel}")


def train_serve_check(sm: Smoke, cfg, tuned, prompt, tmp):
    """The trained tree back to serving: `native_roundtrip` (export, save,
    `load_quantized`), then `generate` on the reloaded tree stored as the
    trained one (`same_layout`): ROUNDTRIP_STEPS greedy ids equal to the
    in-memory tree's, bit for bit, with rows 11, 3 and 4 launched as
    qlora-1b counts them. Returns the reloaded run's launches."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    reloaded, _, _ = native_roundtrip(sm, TRAIN_LABEL, cfg, tuned, tmp / "trained.safetensors")
    reloaded = same_layout(reloaded, tuned)
    n_new, L = ROUNDTRIP_STEPS + 1, cfg.num_layers

    def run(tree):
        cache = QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device=prompt.device)
        out = generate(tree, cfg, prompt, max_new_tokens=n_new, cache=cache)
        sync(torch, prompt.device)
        return out

    want_ids = run(tuned)
    reset_launch_counts()
    ids = run(reloaded)
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(quant_matmul=(7 * L + 1) * (n_new - 1),
                decode_attention_update=L * (n_new - 1), flash_attention=L)
    sm.exact(ids, want_ids, f"{TRAIN_LABEL}: greedy ids of the reloaded trained tree")
    sm.expect(counts == want, f"{TRAIN_LABEL}: generate launches {counts} != {want}")
    print(f"{TRAIN_LABEL}: the reloaded trained tree's {n_new} greedy ids equal the "
          f"in-memory tree's; launches {({k: v for k, v in counts.items() if v})}", flush=True)
    return counts


def phase_train(sm: Smoke, qlora, smi: str):
    """train: qlora-1b-train, QLoRA fine-tuning of phase qlora-1b's tree
    (Llama-3.2-1B, int8 g32 bases with f32 scales, rank-16 bf16 adaptors,
    the head tied to the embedding) at full width: its first step held
    against the CPU port on a 2-layer cut (`train_check_against_cpu`), then
    TRAIN_STEPS Adam steps with remat on one batch (`TRAIN_BATCH`): the
    loss descends, no kernel is launched, the frozen bytes are unchanged;
    each step's loss and wall ms, the peak memory, one profiled step's device
    split (`train_step_split`); then `train_serve_check`. Then
    `train_fixture`. Returns the serve check's launches."""
    torch = sm.torch
    import shutil
    import tempfile
    from pathlib import Path

    from metalchat_tpu_torch import train as tt
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, params, prompt = qlora[0], qlora[1], qlora[5]
    dev = params["final_norm"].device
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    rows, s = TRAIN_BATCH
    tokens = torch.randint(0, cfg.vocab_size, (rows, s + 1), generator=gen, device=dev)
    batch = {"tokens": tokens, "loss_mask": torch.ones(rows, s, device=dev)}
    reset_launch_counts()
    train_check_against_cpu(sm, cfg, params, tokens)

    trainable, frozen, spec = tt.partition(params, tt.trainable_lora)
    before = [t.clone() for t in frozen]
    init, step = tt.make_train_step(cfg, lambda ps: torch.optim.Adam(ps, lr=TRAIN_LR), spec,
                                    remat=True)
    state = init(trainable)
    sync(torch, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if cuda else float("nan")  # earlier phases' too
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() if cuda else float("nan")
    counts = launch_counts()
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    print(f"{TRAIN_LABEL}: {TRAIN_STEPS} Adam steps (lr {TRAIN_LR}, remat) on {rows} x {s} "
          f"inputs ({rows * s} label positions), {len(trainable)} adaptor leaves "
          f"({sum(t.numel() for t in trainable)} parameters): losses {losses}, wall ms "
          f"{[round(t, 3) for t in ms]}, median after the first {steady:.3f} ms "
          f"({rows * s / steady * 1e3:.1f} label tokens/s), peak memory "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - held) / 2 ** 30:.3f} GiB over the "
          f"{held / 2 ** 30:.3f} held before the steps), kernel launches "
          f"{sum(counts.values())}; "
          f"{(smi or 'card not named').splitlines()[0]}", flush=True)
    sm.expect(all(math.isfinite(x) for x in losses), f"{TRAIN_LABEL}: losses {losses}")
    sm.expect(losses[-1] < losses[0] - 0.02, f"{TRAIN_LABEL}: the loss did not descend: "
              f"{losses}")
    sm.expect(not any(counts.values()), f"{TRAIN_LABEL}: the train steps launched {counts}")
    sm.expect(all(torch.equal(a, b) for a, b in zip(before, frozen)),
              f"{TRAIN_LABEL}: a frozen leaf changed")
    del before
    state = train_step_split(torch, step, state, frozen, batch)
    tuned = tt.combine([t.detach() for t in state.trainable], frozen, spec)
    tmp = Path(tempfile.mkdtemp(prefix="metalchat_train_"))
    try:
        serve_counts = train_serve_check(sm, cfg, tuned, prompt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, tuned
    if cuda:
        torch.cuda.empty_cache()
    train_fixture(sm, dev)
    train_fixture_tool(sm, dev)
    return serve_counts


def fixture_train_run(torch, device, batches, remat: bool = True):
    """`FIXTURE_TRAIN`'s full fine-tune of the trained fixture in f32 on
    ``device``: (losses, final leaves on the CPU, launches during the
    steps)."""
    from pathlib import Path

    from metalchat_tpu_torch import train as tt
    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    cfg = load_config(fixture / "config.json")
    params = load_params(open_safetensors(fixture), cfg, dtype=torch.float32, max_seq_len=256,
                         device=device)
    trainable, frozen, spec = tt.partition(params, tt.trainable_full)
    init, step = tt.make_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=FIXTURE_TRAIN_LR, weight_decay=1e-4), spec,
        remat=remat)
    state = init(trainable)
    reset_launch_counts()
    losses = []
    for batch in batches:
        state, m = step(state, frozen, {k: v.to(device) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    start = [t.float().cpu() for t in trainable]
    return losses, [t.detach().cpu() for t in state.trainable], start, launch_counts(), cfg, params


def train_fixture(sm: Smoke, dev):
    """train-fixture: `FIXTURE_TRAIN` on the card and on the CPU: every loss
    within FIXTURE_LOSS_RTOL relative and the final leaves' L1 distance
    within 1% of their movement, no kernel launched; then on the card the
    first step's gradients with and without remat within 1e-5."""
    torch = sm.torch
    import numpy as np
    from pathlib import Path

    from metalchat_tpu_torch import train as tt

    rows, s, steps = FIXTURE_TRAIN
    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    toks = np.load(fixture / "eval_tokens.npy")[:steps * rows * (s + 1)].astype(np.int64)
    batches = [{"tokens": torch.from_numpy(w.copy()),
                "loss_mask": torch.ones(rows, s)}
               for w in toks.reshape(steps, rows, s + 1)]
    t0 = time.perf_counter()
    card = fixture_train_run(torch, dev, batches)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = fixture_train_run(torch, "cpu", batches)
    cpu_s = time.perf_counter() - t0
    apart = sum(float((a - b).abs().sum()) for a, b in zip(card[1], cpu[1]))
    moved = sum(float((b - s0).abs().sum()) for b, s0 in zip(cpu[1], card[2]))
    rel = [abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0])]
    print(f"train-fixture: {steps} AdamW steps (f32, all {len(card[1])} float leaves) on "
          f"{rows} x {s} windows of eval_tokens: card losses {card[0]}, CPU {cpu[0]} "
          f"(max {max(rel):.3g} apart); leaves L1 apart {apart:.6g} of {moved:.6g} moved "
          f"({apart / moved:.3g}); card {card_s:.2f} s, CPU {cpu_s:.2f} s; launches "
          f"{sum(card[3].values())}", flush=True)
    sm.expect(max(rel) <= FIXTURE_LOSS_RTOL, f"train-fixture: losses card {card[0]} "
              f"CPU {cpu[0]}")
    sm.expect(apart <= 0.01 * moved, f"train-fixture: leaves {apart} apart of {moved}")
    sm.expect(not any(card[3].values()), f"train-fixture: launches {card[3]}")
    cfg, params = card[4], card[5]
    tokens = batches[0]["tokens"].to(dev)
    grads = []
    for remat in (False, True):
        trainable, frozen, spec = tt.partition(params, tt.trainable_full)
        leaves = [t.detach().clone().requires_grad_(True) for t in trainable]
        with torch.enable_grad():
            loss = tt.causal_lm_loss(tt.combine(leaves, frozen, spec), tokens,
                                     batches[0]["loss_mask"].to(dev), cfg, remat=remat)
            grads.append(torch.autograd.grad(loss, leaves))
    worst = max(float((a - b).abs().max()) for a, b in zip(*grads))
    print(f"train-fixture: the card's gradients with and without remat {worst:.3g} apart "
          "(limit 1e-5)", flush=True)
    sm.expect(worst <= 1e-5, f"train-fixture: remat gradients {worst} apart")


# The fixture trainer's sub-phase: the tool's 10m widths, batch and sequence
# length, its first TOOL_TRAIN_STEPS steps (the default 3000-step schedule's
# warmup), on TOOL_TRAIN_CORPUS_MB of its corpus.
TOOL_TRAIN_STEPS, TOOL_TRAIN_SCHEDULE, TOOL_TRAIN_CORPUS_MB = 20, 3000, 16
TOOL_GENERATE = 16


def train_fixture_tool(sm: Smoke, dev):
    """train-fixture-tool: `tools.train_fixture` on the card at its real
    widths (10m, batch 32, seq 512, lr 3e-4, AdamW under its schedule), the
    first TOOL_TRAIN_STEPS steps into a temporary directory: every loss
    finite, the last five's mean at least 0.1 below the first five's, no
    kernel launched; `save_fixture`'s five files; the written fixture read
    back through the native mapping (one mapping opened), every leaf the
    trained one rounded to bf16 bit for bit, then `generate` of
    TOOL_GENERATE greedy ids from it in f32 on the card and on the CPU:
    equal."""
    torch = sm.torch
    import argparse
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from metalchat_tpu_torch import native
    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.tools import train_fixture as tf

    t0 = time.perf_counter()
    args = tf.parse_args(["--out", "unused", "--steps", str(TOOL_TRAIN_SCHEDULE)])
    train_bytes, eval_bytes = tf.harvest_corpus(TOOL_TRAIN_CORPUS_MB, 1)
    # The first rows of the schedule's crops: `batches` draws row by row.
    data = tf.batches(np.frombuffer(train_bytes, np.uint8).astype(np.int32), args.batch,
                      args.seq, TOOL_TRAIN_STEPS)
    cfg = tf.make_config(args.size)
    params = init_random_params(cfg, seed=0, dtype=torch.float32, max_seq_len=args.seq,
                                device=dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trained, losses = tf.train_steps(params, cfg, data, lr=args.lr, steps=args.steps,
                                     chunk=10, remat=args.remat, log=None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    counts = launch_counts()
    del params
    tmp = Path(tempfile.mkdtemp(prefix="metalchat_fixture_"))
    try:
        args.out = str(tmp)
        tf.save_fixture(trained, cfg, np.frombuffer(eval_bytes, np.uint8).astype(np.int32),
                        losses, argparse.Namespace(**{**vars(args), "steps": TOOL_TRAIN_STEPS}))
        files = sorted(p.name for p in tmp.iterdir())
        native.reset_calls()
        rcfg = load_config(tmp / "config.json")
        card = load_params(open_safetensors(tmp), rcfg, dtype=torch.float32, max_seq_len=64,
                           device=dev)
        opened = native.CALLS["mmap_open"]
        # The written leaves are the trained ones rounded to bf16, bit for bit.
        written = [(k, card[k], trained[k]) for k in ("embed", "final_norm", "lm_head")]
        written += [(k, card["layers"][k], v) for k, v in trained["layers"].items()]
        unequal = [k for k, got_w, w in written
                   if not torch.equal(got_w, w.to(torch.bfloat16).float())]
        cpu = load_params(open_safetensors(tmp), rcfg, dtype=torch.float32, max_seq_len=64,
                          device="cpu")
        prompt = torch.tensor([list(FIXTURE_PROMPT.encode())])
        got = generate(card, rcfg, prompt.to(dev), max_new_tokens=TOOL_GENERATE)[0].tolist()
        want = generate(cpu, rcfg, prompt, max_new_tokens=TOOL_GENERATE)[0].tolist()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    last_lr = tf.lr_schedule(args.lr, args.steps)(TOOL_TRAIN_STEPS - 1)
    print(f"train-fixture-tool: tools/train_fixture.py at its {args.size} widths, batch "
          f"{args.batch} x seq {args.seq}, the first {TOOL_TRAIN_STEPS} steps of its "
          f"{args.steps}-step schedule (lr 0 to {last_lr:.3g}, "
          f"remat {args.remat}): losses {[round(x, 4) for x in losses]} (first five's mean "
          f"{head:.4f}, last five's {tail:.4f}); {train_s:.2f} s for the steps "
          f"({1e3 * train_s / TOOL_TRAIN_STEPS:.1f} ms a step); wrote {files}; reloaded "
          f"through {opened} native mapping, {len(written) - len(unequal)} of {len(written)} "
          f"leaves the trained ones in bf16 bit for bit; generate {TOOL_GENERATE} ids f32 "
          f"card {got}, CPU {want}; launches during the steps {sum(counts.values())}; the "
          f"sub-phase {time.perf_counter() - t0:.1f} s", flush=True)
    sm.expect(all(math.isfinite(x) for x in losses), f"train-fixture-tool: losses {losses}")
    sm.expect(tail < head - 0.1, f"train-fixture-tool: the loss did not descend: {losses}")
    sm.expect(not any(counts.values()), f"train-fixture-tool: the steps launched {counts}")
    sm.expect(files == ["config.json", "eval_tokens.npy", "model.safetensors",
                        "tokenizer.model", "train_meta.json"], f"train-fixture-tool: {files}")
    sm.expect(opened == 1, f"train-fixture-tool: {opened} native mappings for one file")
    sm.expect(not unequal, f"train-fixture-tool: reloaded leaves {unequal} differ from the "
              "trained ones in bf16")
    sm.expect(got == want, "train-fixture-tool: the reloaded fixture's ids differ card "
              "against CPU")


def unpack_codes(leaf, l: int):
    """Layer ``l``'s signed codes ``[in, out]`` (int16) of a per-channel
    leaf, either orientation, int4 unpacked."""
    import torch

    q = leaf.q[l].to(torch.int16)
    axis = -1 if leaf.transposed else -2
    if leaf.bits == 4:
        q = torch.cat([(q & 15) - 8, q >> 4], dim=axis)
    return q.T if leaf.transposed else q


def awq_fold_against_cpu(sm: Smoke, label: str, cfg, params, stats, folded, alpha: float):
    """Layer 0 of ``folded`` (`awq_fold` on the card) against the CPU's fold
    of the same layer on the same statistics: every leaf byte for byte."""
    torch = sm.torch
    from metalchat_tpu_torch.quant.awq import _saliency_scale, awq_fold

    one = {"layers": {k: v[:1].cpu() for k, v in params["layers"].items()}}
    want = awq_fold(one, cfg, {k: v[:1].cpu() for k, v in stats.items()}, alpha=alpha)["layers"]
    differ = [k for k, v in want.items() if not torch.equal(
        folded["layers"][k][:1].cpu().view(torch.uint8), v.view(torch.uint8))]
    spread = {k: _saliency_scale(v[:1], alpha) for k, v in stats.items()}
    print(f"{label}: awq_fold (alpha {alpha}) layer 0 on the card against the CPU's fold on "
          f"the same statistics: {len(want) - len(differ)} of {len(want)} leaves equal byte "
          f"for byte; saliency scales " + ", ".join(
              f"{k} {float(v.min()):.4g}-{float(v.max()):.4g}" for k, v in spread.items()))
    sm.expect(not differ, f"{label}: awq_fold leaves {differ} differ from the CPU's")


def gptq_against_cpu(sm: Smoke, label: str, name: str, w, hessian, leaf, cols: int):
    """Layer 0's ``name`` as the card quantized it (``leaf``) against the
    CPU port on the same weights ``w [in, out]`` and Hessian, the first
    ``cols`` columns, ``refit_iters=2``: at most GPTQ_TOLERANCE's share of
    the codes differ, each by one quantum, and the Hessian objective summed
    over the columns within its relative limit (each side with its own
    scales)."""
    torch = sm.torch
    from metalchat_tpu_torch.quant import gptq

    code_share, obj_rtol = GPTQ_TOLERANCE
    w = w[:, :cols].float().cpu().double()
    H = hessian.cpu()
    t = time.perf_counter()
    q_cpu, s_cpu = gptq._gptq_codes(w, H, qmax=7.0, clip_search=True, act_order=True,
                                    damp=0.01, refit_iters=2, failures=None)
    cpu_s = time.perf_counter() - t
    q_card = unpack_codes(leaf, 0)[:, :cols].cpu()
    s_card = leaf.scales[0, 0, :cols].cpu().double()

    def objective(q, s):
        e = w - q.double() * s
        return float((e * (H @ e)).sum())

    d = (q_card.to(torch.int32) - q_cpu.to(torch.int32))
    share, worst = float((d != 0).double().mean()), int(d.abs().max())
    o_card, o_cpu = objective(q_card, s_card), objective(q_cpu, s_cpu.float().double())
    rel = abs(o_card - o_cpu) / o_cpu
    print(f"{label}: layer 0 {name} (in {w.shape[0]}, {cols} columns) card against the CPU "
          f"port: {share:.6f} of the codes differ (largest {worst} quanta; limit "
          f"{code_share}), Hessian objective {o_card:.6g} against {o_cpu:.6g} ({rel:.3g} "
          f"relative; limit {obj_rtol}); the CPU took {cpu_s:.2f} s")
    sm.expect(worst <= 1 and share <= code_share, f"{label}: {name} codes {share} differ, "
              f"the largest by {worst}")
    sm.expect(rel <= obj_rtol, f"{label}: {name} objective {o_card} against {o_cpu}")


def gptq_against_cpu_all(sm: Smoke, label: str, cfg, params, calib, qparams, alpha: float):
    """What `gptq_quantize_params(awq_alpha=alpha)` rounded, made again as
    it makes it on the card: the AWQ fold (layer 0 against the CPU's,
    `awq_fold_against_cpu`) and the Hessians of the folded model; then
    layer 0's GPTQ_COMPARE leaves of ``qparams`` against the CPU port
    (`gptq_against_cpu`)."""
    from metalchat_tpu_torch.quant.awq import awq_fold, calibration_stats
    from metalchat_tpu_torch.quant.gptq import _TAP_OF, hessian_tap

    stats = calibration_stats(params, cfg, calib)
    folded = awq_fold(params, cfg, stats, alpha=alpha)
    awq_fold_against_cpu(sm, label, cfg, params, stats, folded, alpha)
    hess = calibration_stats(folded, cfg, calib, tap=hessian_tap)
    for name, cols in GPTQ_COMPARE.items():
        gptq_against_cpu(sm, label, name, folded["layers"][name][0], hess[_TAP_OF[name]][0],
                         qparams["layers"][name], cols)


def phase_gptq_1b(sm: Smoke, dev_name: str):
    """gptq-1b: random dense bf16 weights at Llama-3.2-1B's widths, cut to
    GPTQ_LAYERS layers (`init_random_params` on the card, head tied),
    calibration on 8 x 512
    seeded tokens (`calibration_stats` with `hessian_tap`, timed alone),
    `gptq_quantize_params(bits=4, act_bits=8, awq_alpha=GPTQ_AWQ_ALPHA,
    refit_iters=2)` on the card: no factorization falls back; its AWQ fold
    and layer 0's GPTQ_COMPARE leaves against the CPU port
    (`gptq_against_cpu_all`); then export → save → load
    (`native_roundtrip`), `fuse_projections`, and `drive_generate` on the
    reloaded tree (64 row-1 launches a step with the dense tied head) with
    `roundtrip_logits` against the quantized tree."""
    torch = sm.torch
    import shutil
    import tempfile
    from pathlib import Path

    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.quant.awq import calibration_stats
    from metalchat_tpu_torch.quant.gptq import gptq_quantize_params, hessian_tap

    cfg = config_from_dict(LLAMA32_1B_CONFIG).replace(max_seq_len=1024,
                                                      num_layers=GPTQ_LAYERS)
    L = cfg.num_layers
    dev = torch.device("cuda")
    params = init_random_params(cfg, seed=0, dtype=torch.bfloat16, max_seq_len=1024,
                                device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    calib = torch.randint(0, cfg.vocab_size, GPTQ_CALIB, generator=gen, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hess = calibration_stats(params, cfg, calib, tap=hessian_tap)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t
    del hess
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    failures = []
    t = time.perf_counter()
    qparams = gptq_quantize_params(params, cfg, calib, bits=4, act_bits=8,
                                   awq_alpha=GPTQ_AWQ_ALPHA, refit_iters=2, failures=failures)
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t
    fallbacks = sum(int(f.sum()) for f in failures)
    print(f"{GPTQ_LABEL}: calibration (8 x 512 tokens, Hessians of 4 taps x {L} layers, "
          f"f64 on the card) {calib_s:.2f} s; gptq_quantize_params (W4A8, AWQ alpha "
          f"{GPTQ_AWQ_ALPHA}, refit_iters=2, per-channel updates, its two calibration passes "
          f"included) {gptq_s:.2f} s, {(gptq_s - 2 * calib_s) / L:.3f} s a layer past them; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card; "
          f"{sum(f.numel() for f in failures)} factorizations, {fallbacks} fell back",
          flush=True)
    sm.expect(fallbacks == 0, f"{GPTQ_LABEL}: {fallbacks} factorizations fell back")
    gptq_against_cpu_all(sm, GPTQ_LABEL, cfg, params, calib, qparams, GPTQ_AWQ_ALPHA)
    del params
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="metalchat_gptq_"))
    try:
        reloaded, _, _ = native_roundtrip(sm, GPTQ_LABEL, cfg, qparams,
                                          tmp / "native.safetensors")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    qparams, reloaded = fuse_projections(qparams, cfg), fuse_projections(reloaded, cfg)
    run = drive_generate(sm, dev_name, GPTQ_LABEL, cfg, reloaded,
                         {"a8_matvec": 4 * L, "a8_quantize": 4 * L,
                          "decode_attention_update": L})
    roundtrip_logits(sm, GPTQ_LABEL, cfg, qparams, reloaded, run[5])
    return run


def phase_timing_qlora(sm: Smoke, run, rate: float):
    """Row 11 at qlora-1b's decode step, one row: each int8 g32 base with
    its f32 scales and the tied head (`qmm_leaf_times`), summed over the
    step's 113 calls."""
    torch = sm.torch
    cfg, params = run[0], run[1]
    L = cfg.num_layers
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = torch.randn((1, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    xf = torch.randn((1, cfg.intermediate_size), generator=gen, device=dev).to(torch.bfloat16)
    layers = params["layers"]
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for name, leaf, xin, per_step in [(n, layers[n].base, xf if n == "w2" else x, L)
                                      for n in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")] + [
            ("lm_head", params["lm_head"], x, 1)]:
        for key, val in qmm_leaf_times(sm, name, leaf, xin, per_step, rate).items():
            step[key] += per_step * val
    print(f"  quant_matmul at 1 row, one {QLORA_LABEL} decode step ({7 * L + 1} calls): "
          f"{step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms; plain "
          f"{step['plain_ms']:.3f}; matmul on bf16 weights {step['library_ms']:.4f})")
    return step


def phase_timing_gpt2(sm: Smoke, gpt2_run, rate: float):
    """Rows 1 and 3 at GPT-2 XL's decode shapes beside their bounds: one
    decode step's 192 matvec calls at one row (wqkv, wo, w1, w2 a layer;
    int8, no prologue) and its 48 decode_attention_update calls at the
    main prompt's last length (576); the plain versions and the library
    yardsticks as phase timing's (torch._int_mm at M=17, SDPA)."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm

    cfg, params, cache, _, length, _ = gpt2_run
    dev = torch.device("cuda")
    L, nh, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    layers = params["layers"]
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, quantize_ms=0.0)
    for name in ("wqkv", "wo", "w1", "w2"):
        pq, ps = layers[name].q, layers[name].scales
        _, out_f, in_f = pq.shape
        x = torch.randn((1, in_f), generator=gen, device=dev).to(torch.bfloat16)
        ms = sm.device_ms(lambda i: am.quant_matvec_stacked_fused(x, pq, ps, i % L, bits=8), 64)
        qms = sm.device_ms(lambda i: am.quantize_rows(x), 64)
        plain = sm.eager_ms(lambda i: am.quant_matvec_stacked_fused_plain(
            x, pq, ps, i % L, bits=8), 3)
        xq17 = torch.randint(-127, 128, (17, in_f), generator=gen, device=dev,
                             dtype=torch.int8)
        lib = sm.device_ms(lambda i: torch._int_mm(xq17, pq[i % L].t()), 32)
        nbytes = out_f * in_f + out_f * 4 + (in_f + out_f) * 2
        b_ms, _ = bound(nbytes, 2 * in_f * out_f, "int8", rate)
        print(f"  a8_matvec {name} [{out_f}x{in_f} w8]: {ms * 1e3:.2f} us (bound "
              f"{b_ms * 1e3:.2f} us, bytes; its a8_quantize alone {qms * 1e3:.2f} us; plain "
              f"{plain * 1e3:.1f} us; _int_mm M=17 {lib * 1e3:.2f} us) x{L}/token")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b_ms), ("quantize_ms", qms)):
            step[key] += L * val
    print(f"{GPT2_LABEL} row 1 at one row, one decode step ({4 * L} calls): "
          f"{step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms, bytes; a8_quantize alone "
          f"{step['quantize_ms']:.4f} ms; plain {step['plain_ms']:.3f} ms; _int_mm M=17 "
          f"{step['library_ms']:.4f} ms)")
    nkv = cfg.num_kv_heads
    q = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((1, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    ms = sm.device_ms(lambda i: dm.decode_attention_update_quantized_stacked(
        q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 64)
    plain = sm.eager_ms(lambda i: dm.decode_attention_update_plain(
        q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 5)
    kd = dequantize_kv(cache.k[0, :, :, :length], cache.k_scale[0, :, :, :length])
    vd = dequantize_kv(cache.v[0, :, :, :length], cache.v_scale[0, :, :, :length])
    lib = sm.device_ms(lambda i: F.scaled_dot_product_attention(q[:, :, None, :], kd, vd), 64)
    nbytes = (2 * nkv * length * (hd + 4) + 2 * nh * hd * 2 + 2 * nkv * hd * 2
              + 2 * nkv * (hd + 4))
    b_ms, b_by = bound(nbytes, 4 * nh * hd * length, "f32", rate)
    print(f"{GPT2_LABEL} row 3 [length {length}, {nh} heads over {nkv}], one decode step "
          f"({L} calls): {L * ms:.5f} ms (bound {L * b_ms:.6f} ms, {b_by}; plain "
          f"{L * plain:.4f} ms; sdpa bf16 {L * lib:.5f} ms)")
    return dict(row1=step, row3=dict(ms=L * ms, bound_ms=L * b_ms, plain_ms=L * plain,
                                     library_ms=L * lib))


# -- Mixtral-8x7B W4A8 at full width ------------------------------------------

MIXTRAL_LABEL = "mixtral-8x7b-w4a8"
EXPERT_LEAVES = ("w1", "w3", "w2")


def make_mixtral(sm: Smoke, device, **cut):
    """Mixtral-8x7B at its published widths (`MixtralConfig.mixtral_8x7b`:
    hidden 4096, 32 layers, 32 query heads over 8 kv heads, hd 128, 8
    experts, top-2, intermediate 14336, vocab 32000), context 1024, W4A8
    per-channel, random weights from seeded torch.Generators on ``device``:
    attention, lm_head, norms and embedding from
    `init_random_quantized_params`; the expert stacks ``q [L, E, out, in/2]``
    with scales ``[L, E, 1, out]`` built here in that function's ranges
    (bytes in [-127, 127], scales in [0.001, 0.011)), and a dense bf16
    router ``[L, H, E]`` of N(0, 0.02), as `init_random_params` draws it.
    wqkv fused; the experts stay apart. ``cut`` replaces config fields."""
    torch = sm.torch
    from metalchat_tpu_torch.config import MixtralConfig
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor, init_random_quantized_params

    cfg = MixtralConfig.mixtral_8x7b().replace(max_seq_len=1024, **cut)
    dev = torch.device(device)
    t0 = time.perf_counter()
    params = init_random_quantized_params(cfg, max_seq_len=cfg.max_seq_len, seed=0,
                                          device=dev, **W4A8)
    layers = params["layers"]
    L, E, H, F = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for name, (in_f, out_f) in zip(EXPERT_LEAVES, ((H, F), (H, F), (F, H))):
        del layers[name]  # the dense FFN's leaf
        q = torch.randint(-127, 128, (L, E, out_f, in_f // 2), generator=gen, device=dev,
                          dtype=torch.int8)
        scales = (torch.rand((L, E, 1, out_f), generator=gen, device=dev) * 0.01
                  + 0.001).to(torch.bfloat16)
        layers[name] = QuantizedTensor(q=q, scales=scales, bits=4, group_size=in_f,
                                       transposed=True, act_bits=8)
    layers["router"] = (torch.randn((L, H, E), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    params = fuse_projections(params, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"{MIXTRAL_LABEL} params ({L} layers): {weight_bytes(params) / 1e9:.4f} GB of "
          f"weights ({expert_bytes(params) / 1e9:.4f} GB experts), made in "
          f"{time.perf_counter() - t0:.1f} s on {device}")
    return cfg, params


def expert_bytes(params) -> int:
    return sum(params["layers"][n].q.numel() + params["layers"][n].scales.numel()
               * params["layers"][n].scales.element_size() for n in EXPERT_LEAVES)


def routed_weight_bytes(cfg, params) -> float:
    """The weight bytes one batch-1 decode step reads (bench.py's accounting
    with routed experts): every weight but the embedding table, the expert
    stacks counted at K of E."""
    experts = expert_bytes(params)
    return weight_bytes(params) - experts + experts * cfg.num_experts_per_tok / cfg.num_experts


@contextlib.contextmanager
def recorded_routing(torch, calls: list, forced=None):
    """Inside the block, every routing (`models.moe.route`, which the decode
    path calls too) appends to ``calls``, on the CPU, the expert ids it used
    ``[T, K]`` and its router probabilities ``[T, E]`` (f32): the gap
    between a token's K-th and (K+1)-th is how near a tie it was (one that
    two sum orders may break apart, sending the token to another expert).
    ``forced`` maps a routing's index in the block to expert ids ``[T, K]``:
    that routing takes them, its gates the router probabilities at them
    renormalised, as `route` renormalises its own."""
    from metalchat_tpu_torch.models import decode as dmod
    from metalchat_tpu_torch.models import moe as mmod

    real, forced = mmod.route, forced or {}

    def spy(xt, router, config):
        probs, gates, idx = real(xt, router, config)
        if len(calls) in forced:
            idx = forced[len(calls)].to(idx.device)
            gates = probs.gather(1, idx)
            gates = gates / gates.sum(dim=-1, keepdim=True)
        calls.append((idx.cpu(), probs.float().cpu()))
        return probs, gates, idx

    mmod.route = dmod.route = spy
    try:
        yield calls
    finally:
        mmod.route = dmod.route = real


# The card's router probabilities drift from the CPU's by up to 0.007 each
# (mixtral-fixture's runs), so two sum orders swap a K-th and a (K+1)-th
# choice only where the CPU put them at most twice that apart. A token that
# the card sent to an expert the CPU ranked further below is a fault.
ROUTER_TIE_GAP = 0.014


def smallest_router_gap(calls) -> float:
    """The smallest K-th minus (K+1)-th router probability of `recorded_routing`'s calls."""
    gaps = []
    for idx, probs in calls:
        top = probs.topk(idx.shape[1] + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
    return min(gaps)


def routing_flips(cpu_calls, card_calls, layers: int) -> list:
    """Each (routing, token) where the card took other experts than the
    CPU's router picks (its top K, which is what it takes unforced): its
    step (a prefill, then one a decode step), layer, token row, both sides'
    experts and the CPU's router gap there: how far above the least likely
    expert the card took the CPU put the likeliest one the card dropped
    (for a swapped K-th and (K+1)-th choice, their gap)."""
    flips = []
    for i, ((_, probs), (b, _)) in enumerate(zip(cpu_calls, card_calls)):
        a = probs.topk(b.shape[1], dim=-1).indices
        for row in range(a.shape[0]):
            mine, theirs = sorted(a[row].tolist()), sorted(b[row].tolist())
            if mine != theirs:
                p = probs[row]
                dropped = max(float(p[e]) for e in mine if e not in theirs)
                taken = min(float(p[e]) for e in theirs if e not in mine)
                flips.append(dict(call=i, step=i // layers, layer=i % layers, row=row,
                                  cpu=mine, card=theirs, gap=dropped - taken))
    return flips


def held_to_routing(sm: Smoke, what: str, cpu_calls, card_calls, layers: int, rerun,
                    sides=("the card", "the CPU")):
    """Where the card (``card_calls``, `recorded_routing`'s) took other
    experts than the CPU (``cpu_calls``) for a token: ``rerun()`` is made
    again on the CPU's side with every routing forced to the card's, and
    each routing where the card took other experts than the CPU's router
    picks given the card's earlier routings (a flip; one that only follows
    an earlier flip is none) must be a near tie (`check_near_ties`).
    Returns (those flips, the rerun's result), or ([], None) where both
    sides routed alike."""
    if not routing_flips(cpu_calls, card_calls, layers):
        return [], None
    forced = {i: idx for i, (idx, _) in enumerate(card_calls)}
    with recorded_routing(sm.torch, [], forced) as given:
        held = rerun()
    flips = routing_flips(given, card_calls, layers)
    check_near_ties(sm, what, flips, sides)
    return flips, held


def check_near_ties(sm: Smoke, what: str, flips, sides=("the card", "the CPU")) -> None:
    """Every routing flip at a router gap of at most ROUTER_TIE_GAP, each
    printed with its gap."""
    for f in flips:
        where = f"{what}: step {f['step']} layer {f['layer']} token {f['row']}"
        sm.expect(f["gap"] <= ROUTER_TIE_GAP,
                  f"{where}: {sides[0]} routed to experts {f['card']}, {sides[1]} to {f['cpu']} "
                  f"at a router gap {f['gap']:.3g} > {ROUTER_TIE_GAP}: not a near tie")
        print(f"{where}: {sides[0]} routed to experts {f['card']}, {sides[1]} to {f['cpu']} "
              f"(router gap {f['gap']:.3g} <= {ROUTER_TIE_GAP}, a near tie); that step is held "
              f"to {sides[1]} given {sides[0]}'s routing", flush=True)


def check_routed_logits(sm: Smoke, what: str, cfg, cpu_params, prompt, ids, want, cpu_calls,
                        got, card_calls):
    """`check_logits` of the card's teacher-forced logits ``got`` (fed the
    CPU's ``ids``) against the CPU's ``want``, where both sides routed every
    token alike (``cpu_calls``, ``card_calls``: `recorded_routing`'s). Where
    the card picked other experts for a token, the CPU's teacher-forced run
    is made again given the card's routing, and the card's logits are held
    to that run, at the same limit; each flip must be a router near tie
    that the two sides' sum orders break apart (`moe.route` is the JAX
    package's, and so is the flip): a CPU router gap of at most
    ROUTER_TIE_GAP (`held_to_routing`, `check_near_ties`, which prints
    each). Returns (the worst share of the limit, the flips, the logits
    held to)."""
    sm.expect(len(cpu_calls) == len(card_calls),
              f"{what}: {len(card_calls)} routings on the card, {len(cpu_calls)} on the CPU")
    flips, held = held_to_routing(sm, what, cpu_calls, card_calls, cfg.num_layers,
                                  lambda: teacher_forced_logits(cpu_params, cfg, prompt, ids))
    if held is None:
        return check_logits(sm, what, got, want), flips, want
    return check_logits(sm, f"{what} (the CPU given the card's routing)", got, held), flips, held


def check_routed_ids(sm: Smoke, what: str, out, ids, flips, held) -> str:
    """The card's greedy ids ``out [B, steps]`` against the CPU's ``ids``:
    equal, or parted first at a step at or after a named routing flip
    (`check_routed_logits`) where the CPU given the card's routing
    (``held``, its logits ``[steps, B, V]``) picks the card's ids."""
    torch = sm.torch
    parts = [j for j in range(ids.shape[1]) if not torch.equal(out[:, j], ids[:, j])]
    if not parts:
        return "identical"
    j = parts[0]
    flipped = [f["step"] for f in flips if f["step"] <= j]
    sm.expect(bool(flipped), f"{what}: greedy ids part at step {j} (card {out[:, j].tolist()}, "
              f"CPU {ids[:, j].tolist()}) with no routing flip at or before it")
    choice = held[j].argmax(-1)
    sm.expect(torch.equal(choice, out[:, j]),
              f"{what}: at step {j} the CPU given the card's routing picks {choice.tolist()}, "
              f"the card {out[:, j].tolist()}")
    return f"parted at step {j}, after the routing flip at step {flipped[0]}"


def greedy_logits(params, cfg, prompts, steps: int):
    """Greedy decode as a loop of `forward` calls on an int8 cache: the ids
    ``[B, steps]`` and each step's last-position logits ``[steps, B, V]``
    (f32, on the CPU), the CPU's reference for `teacher_forced_logits`."""
    import torch

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    device = params["final_norm"].device
    b, s = prompts.shape
    cache = QuantizedKVCache.create(cfg, b, min(cfg.max_seq_len, s + steps), device=device)
    logits, _ = forward(params, cache, prompts.to(device), 0, cfg)
    out, ids = [logits[:, -1].float().cpu()], [logits[:, -1].argmax(-1)]
    for i in range(steps - 1):
        logits, _ = forward(params, cache, ids[-1][:, None], s + i, cfg)
        out.append(logits[:, -1].float().cpu())
        ids.append(logits[:, -1].argmax(-1))
    return torch.stack(ids, dim=1).cpu(), torch.stack(out)


# The correctness cell: Mixtral-8x7B's widths cut to 1 layer and to 2 (the
# second routes on an earlier MoE layer's output, and reads the stacked
# experts past the first layer's), bf16, a 96-token prompt (over 32 tokens,
# so the prefill takes `_moe_dispatch`) and 4 steps at 1 and 2 rows (both the
# sparse decode formulation), so that the CPU's plain path stays short. A
# token at a router near tie may take another expert on the card:
# `check_routed_logits` names such a step and holds it to the CPU given the
# card's routing.
MIXTRAL_FIXTURE_LAYERS = (1, 2)
MIXTRAL_FIXTURE_PROMPT, MIXTRAL_FIXTURE_STEPS = 96, 4


def phase_mixtral_fixture(sm: Smoke):
    """Mixtral W4A8 cut to each of MIXTRAL_FIXTURE_LAYERS, int8 KV, bf16: the
    card against the CPU's plain path on the same params (made on the card,
    copied). For 1 and 2 rows: the CPU's greedy run, then each of its
    MIXTRAL_FIXTURE_STEPS steps' logits on the card fed the CPU's tokens,
    both sides' routing recorded (`check_routed_logits`: a step where the
    card picked other experts is held to the CPU given the card's routing);
    launches exact (flash a layer for the prefill; per decode step the
    host-index and the indexed matvec calls of `matvec_calls` and one
    attention launch a layer); the card's greedy ids through `generate`
    equal to the CPU's, or parted after a named flip (`check_routed_ids`).
    Prints the smallest gap between the 2nd and 3rd router probability seen
    on either side."""
    for layers in MIXTRAL_FIXTURE_LAYERS:
        mixtral_fixture_cut(sm, layers)
        sm.torch.cuda.empty_cache()


def mixtral_fixture_cut(sm: Smoke, layers: int):
    """`phase_mixtral_fixture` at one cut of ``layers`` layers."""
    torch = sm.torch
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, card_params = make_mixtral(sm, "cuda", num_layers=layers)
    cpu_params = to_device(card_params, torch.device("cpu"))
    L, steps = cfg.num_layers, MIXTRAL_FIXTURE_STEPS
    gen = torch.Generator()
    gen.manual_seed(4)
    for b in (1, 2):
        prompt = torch.randint(0, cfg.vocab_size, (b, MIXTRAL_FIXTURE_PROMPT), generator=gen)
        t0 = time.perf_counter()
        with recorded_routing(torch, []) as cpu_calls:
            ids, want = greedy_logits(cpu_params, cfg, prompt, steps)
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        with recorded_routing(torch, []) as card_calls:
            got = teacher_forced_logits(card_params, cfg, prompt, ids)
        counts = launch_counts()
        out = generate(card_params, cfg, prompt.cuda(), max_new_tokens=steps,
                       quantized_kv=True).cpu()
        gap = min(smallest_router_gap(cpu_calls), smallest_router_gap(card_calls))
        label = f"mixtral-fixture L={L} B={b}"
        share, flips, held = check_routed_logits(sm, f"{label} logits", cfg, cpu_params, prompt,
                                                 ids, want, cpu_calls, got, card_calls)
        parting = check_routed_ids(sm, label, out, ids, flips, held)
        print(f"{label} ({MIXTRAL_LABEL} widths cut to {L} layers; bf16, int8 "
              f"KV; prompt {MIXTRAL_FIXTURE_PROMPT}, {steps} steps; the CPU's run "
              f"{cpu_s:.1f} s): logits max abs err {(got - held).abs().max().item()}, "
              f"{share:.4f} of the limit; routing flips card vs CPU {len(flips)}; smallest "
              f"2nd-3rd router probability gap {gap:.3g}; greedy ids card {out.tolist()}, CPU "
              f"{ids.tolist()} ({parting}); card launches {counts}", flush=True)
        expected = {**dict.fromkeys(counts, 0), "flash_attention": L,
                    "decode_attention_update": L * (steps - 1)}
        for k, n in matvec_calls(cfg, b).items():
            expected[k] = n * (steps - 1)
        sm.expect(counts == expected, f"{label}: launches {counts} != {expected}")


def phase_mixtral(sm: Smoke, dev_name: str):
    """Mixtral-8x7B W4A8 (all 32 layers) through `generate`: a 512-token
    prompt (the prefill's MoE takes `_moe_dispatch`), 64 greedy tokens;
    launches exact (a step: wqkv and wo a layer and lm_head, 192 indexed
    expert calls, 32 decode_attention_update; 32 flash a prefill), the graph
    route equal to the eager loop bit for bit; its profile."""
    cfg, params = make_mixtral(sm, "cuda")
    run = drive_generate(sm, dev_name, MIXTRAL_LABEL, cfg, params,
                         {**matvec_calls(cfg, 1), "decode_attention_update": cfg.num_layers},
                         weights_per_token=routed_weight_bytes(cfg, params))
    phase_profile(sm, run, MIXTRAL_LABEL)
    return run


def scan_caches(torch, cfg, dev):
    """The scan phase's caches of one row and 1024 positions: int8 dense,
    bf16 dense, and int8 pages of 256 (4 pages, shuffled in the table)."""
    from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache

    def paged():
        c = PagedKVCache.create(cfg, num_pages=4, page_size=256, max_slots=1, device=dev)
        c.page_table.copy_(torch.tensor([[2, 0, 3, 1]], dtype=torch.int32))
        return c

    return {"int8": (lambda: QuantizedKVCache.create(cfg, 1, 1024, device=dev),
                     "decode_attention_layer"),
            "bf16": (lambda: KVCache.create(cfg, 1, 1024, dtype=torch.bfloat16, device=dev),
                     "decode_attention_layer"),
            "paged": (paged, "paged_decode_attention_layer")}


SCAN_STEPS = 16


def phase_scan(sm: Smoke, main):
    """The JAX package's scan route at one token: `forward(fast_decode=False)`
    on phase main's 8b-w4a8 params and prompt, after the same 512-token
    prefill, on an int8 dense, a bf16 dense and a paged cache. SCAN_STEPS
    steps fed the fast route's greedy tokens: each step's logits within
    `check_logits`'s limit of the fast route's; launches exact (the cache
    written by the layer route, then one row-6 or row-7 launch a layer;
    the linears are plain products, so no matvec, and no row 3 or 8)."""
    torch = sm.torch
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, params, _, _, _, prompt = main
    L, s = cfg.num_layers, prompt.shape[1]
    dev = torch.device("cuda")
    out = dict(counts=dict.fromkeys(launch_counts(), 0), caches={}, length=s + SCAN_STEPS,
               cfg=cfg)
    for kind, (make, counter) in scan_caches(torch, cfg, dev).items():
        fast_c, scan_c = make(), make()
        first, _ = forward(params, fast_c, prompt, 0, cfg)
        forward(params, scan_c, prompt, 0, cfg)
        tok, fast = first[:, -1].argmax(-1), []
        for i in range(SCAN_STEPS):
            logits, _ = forward(params, fast_c, tok[:, None], s + i, cfg)
            fast.append((tok, logits[:, -1].float().cpu()))
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        scan = [forward(params, scan_c, t[:, None], s + i, cfg, fast_decode=False)[0][:, -1]
                .float().cpu() for i, (t, _) in enumerate(fast)]
        scan_s = time.perf_counter() - t0
        counts = launch_counts()
        got, want = torch.stack(scan), torch.stack([l for _, l in fast])
        share = check_logits(sm, f"scan {kind}", got, want)
        print(f"scan 8b-w4a8 {kind} cache: {SCAN_STEPS} one-token steps of forward("
              f"fast_decode=False) in {scan_s:.3f} s; logits against the fast route max abs "
              f"err {(got - want).abs().max().item()}, {share:.4f} of the limit; launches "
              f"{counts}", flush=True)
        expected = {**dict.fromkeys(counts, 0), counter: L * SCAN_STEPS}
        sm.expect(counts == expected, f"scan {kind}: launches {counts} != {expected}")
        for k, n in counts.items():
            out["counts"][k] += n
        out["caches"][kind] = scan_c
    return out


# -- speculative decoding (engine/speculative.py) ---------------------------------

# -- phase tp: tensor-parallel decode and serving, two ranks on one card --------

TP_RANKS = 2
# gloo: NCCL refuses two ranks on one device, and this machine has one card.
# gloo all_reduces CUDA tensors through the host, so the phase's times are
# functional numbers, not a tensor-parallel speed figure.
TP_BACKEND = "gloo"
TP_PROMPT, TP_STEPS = 512, 32
TP_SERVE = dict(max_slots=8, prefill_chunk=256, cache_mode="paged", page_size=256,
                decode_burst=8)
TP_SERVE_REQUESTS, TP_SERVE_NEW = 8, 48
TP_STEP_REL_L2 = 5e-2  # JAX's tolerance for per-shard act-quant (tests/test_tp_decode.py)
TP_COLLECTIVE_TIMEOUT_S = 180  # a collective waiting on a lost peer raises
TP_TIMEOUT_S = 420  # the parent kills ranks still running after this
TP_LABEL = f"{TP_RANKS} ranks over {TP_BACKEND} on one card"


def tree_digest(torch, params):
    """One int64 a tensor of the tree (in a fixed walk): its bytes, each
    weighted by its position mod 65521 plus 1, summed; equal trees give
    equal digests."""
    from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

    leaves = []

    def walk(node):
        if isinstance(node, QuantizedTensor):
            leaves.extend((node.q, node.scales))
        elif isinstance(node, LoraLinear):
            walk(node.base)
            leaves.extend((node.a, node.b))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            leaves.append(node)

    walk(params)
    chunk = 1 << 24
    w = torch.arange(chunk, dtype=torch.int32, device=leaves[0].device) % 65521 + 1
    out = []
    for t in leaves:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        acc = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, b.numel(), chunk):
            c = b[i:i + chunk]
            acc += (c.to(torch.int32) * w[:c.numel()]).sum(dtype=torch.int64)
        out.append(acc)
    return torch.stack(out).cpu()


def seeded_prompt(torch, cfg, device):
    """A prompt of TP_PROMPT tokens from a generator seeded 0 on ``device``
    (drive_generate's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (1, TP_PROMPT), generator=gen, device=device)


def same_tree(torch, params) -> dict:
    """This rank's tree digest and whether every rank of the process group
    (one all_reduce max of the digest and its negation) holds the same
    bytes."""
    import torch.distributed as dist

    digest = tree_digest(torch, params)
    both = torch.cat([digest, -digest]).cuda()
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    both = both.cpu()
    return {"digest": digest, "same_bytes": bool(torch.equal(both[:len(digest)], digest)
                                                 and torch.equal(-both[len(digest):], digest))}


def spawn_ranks(sm: Smoke, what: str, target, n: int, timeout_s: float, tmp: str):
    """Run ``target(rank, store, out_dir)`` in ``n`` spawned processes, kill
    those still running after ``timeout_s``, and load each rank's
    ``rank{r}.pt``; returns (the ranks' results, wall seconds)."""
    import multiprocessing

    torch = sm.torch
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, f"{tmp}/store", tmp), daemon=True)
             for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, t0 + timeout_s - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    wall = time.perf_counter() - t0
    sm.expect(not hung, f"{what}: ranks {hung} still running after {timeout_s} s (killed)")
    codes = [p.exitcode for p in procs]
    sm.expect(codes == [0] * n, f"{what}: rank exit codes {codes}")
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(n)], wall


def tp_greedy(torch, fwd, params, cache, prompt, steps: int):
    """A prefill of ``prompt`` [1, S], then ``steps`` (at least one) greedy
    one-token steps, through ``fwd(params, cache, tokens, start_pos)``: the
    prefill's logits [S, V], the first step's [V], layer 0's K/V codes and
    scales over the S + 1 written positions after that step, the ids [steps
    + 1] (the prefill's, then each step's), the launches of the prefill and
    of the steps, and the prefill's and the steps' wall seconds (all on the
    CPU), and the logits that chose each id (``last`` [steps + 1, V])."""
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    s = prompt.shape[1]
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    logits, _ = fwd(params, cache, prompt, 0)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_counts = launch_counts()
    out = {"prefill": logits[0].float().cpu()}
    tok = logits[:, -1].argmax(-1)
    ids, last = [tok], [logits[0, -1].float()]
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    for i in range(steps):
        logits, _ = fwd(params, cache, tok[:, None], s + i)
        tok = logits[:, -1].argmax(-1)
        ids.append(tok)
        last.append(logits[0, -1].float())
        if i == 0:
            out["step1"] = logits[0, -1].float().cpu()
            out["layer0"] = {n: getattr(cache, n)[0, 0, :, :s + 1].cpu().clone()
                             for n in ("k", "v", "k_scale", "v_scale")}
    torch.cuda.synchronize()
    out.update(steps_s=time.perf_counter() - t, step_counts=launch_counts(),
               prefill_counts=prefill_counts, prefill_s=prefill_s, ids=torch.cat(ids).cpu(),
               last=torch.stack(last).cpu())
    return out


def tp_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase tp, a process of its own (`phase_tp` starts it with
    ``spawn``). It joins the gloo group through the ``file://`` store,
    makes the seeded 8b-w4a8 tree (`make_8b`), checks with one all_reduce
    that every rank holds the same bytes, builds `MultiHostEngine` on it
    (which shards it; the whole tree is then freed), runs `tp_greedy` and
    `generate` through `tp_decode_forward_fn` on the engine's local tree,
    then serves `serve_workload`'s first requests (rank 0's; the others
    pass None), and saves what it saw to ``out_dir/rank{rank}.pt``. Its
    `tp_greedy` takes one step (the first step's logits and layer 0's
    codes); the `TP_STEPS` steps and their ids are `generate`'s. The
    kernels were built by phase build: this process loads them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    import importlib

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.parallel import (
        MultiHostEngine,
        initialize,
        make_mesh,
        shard_cache,
        shutdown,
        tp_decode_forward_fn,
    )

    gm = importlib.import_module("metalchat_tpu_torch.engine.generate")
    initialize(f"file://{store}", TP_RANKS, rank, backend=TP_BACKEND,
               timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    try:
        mesh = make_mesh()
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        cfg, full = make_8b(Smoke(torch), f"tp rank {rank}: 8b-w4a8", bits=4, group_size=None,
                            act_bits=8)
        out = same_tree(torch, full)
        engine = MultiHostEngine(full, cfg, mesh, **TP_SERVE)
        local = engine.engine.params
        torch.cuda.synchronize()
        out.update(setup_s=time.perf_counter() - t0, local_bytes=weight_bytes(local),
                   memory=torch.cuda.memory_allocated())
        prompt = seeded_prompt(torch, cfg, dev)
        fwd = tp_decode_forward_fn(local, cfg, mesh)

        def cache():
            return shard_cache(QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device=dev),
                               mesh)

        out["prompt"] = prompt.cpu()
        out["greedy"] = tp_greedy(torch, fwd, local, cache(), prompt, 1)
        captures = []
        with timed_captures(torch, gm, captures):
            reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids = gm.generate(local, cfg, prompt, max_new_tokens=TP_STEPS + 1, cache=cache(),
                              forward_fn=fwd)
            torch.cuda.synchronize()
        out.update(generate_ids=ids[0].cpu(), generate_counts=launch_counts(),
                   generate_captures=len(captures), generate_s=time.perf_counter() - t)
        requests = (serve_workload(cfg, TP_SERVE_REQUESTS, TP_SERVE_NEW) if rank == 0
                    else None)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        done = engine.run(requests)
        torch.cuda.synchronize()
        out.update(serve_s=time.perf_counter() - t, serve_counts=launch_counts(),
                   serve_counters=dict(engine.engine.counters),
                   serve_shapes=dict(engine.engine.prefill_shapes),
                   serve_captures=len(engine.engine._graphs),
                   serve_streams=[(c.tokens, c.finished, c.error) for c in done.values()],
                   serve_prompts=[len(r.prompt) for r in requests] if requests else None,
                   collectives=dict(mesh.counts))
        del engine, local
        torch.cuda.empty_cache()
        out.update(pp_cp_rank(torch, cfg, full, rank, prompt))
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        shutdown()


# Pipeline and context parallelism, in phase tp's two ranks (`pp_cp_rank`).
PP_STEPS = TP_STEPS
CP_PROMPT, CP_CACHE, CP_THRESHOLD = 1536, 2048, 512
PP_CP_SERVE = dict(max_slots=8, prefill_chunk=256, decode_burst=8)
# Both at once on the same two ranks (`pp_x_cp_rank`): the CP_PROMPT-token
# prompt (the ring prefill) and two under CP_THRESHOLD (chunked through the
# stages), PP_X_CP_NEW greedy tokens each.
PP_X_CP_SHORT, PP_X_CP_NEW = (300, 100), 16


def timed_run(torch, fn, mesh=None):
    """``fn()`` with the launches, wall seconds (synchronized) and, given a
    mesh, the collectives it made: (result, launches, seconds, moves)."""
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    before = dict(mesh.counts) if mesh is not None else {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    moves = {} if mesh is None else {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                                     if v != before.get(k, 0)}
    return out, launch_counts(), secs, moves


def with_rope(params, cfg, positions: int):
    """``params`` with rope tables of ``positions`` rows (the same rows
    first: each row depends only on its position), and the config."""
    from metalchat_tpu_torch.models.transformer import make_rope_tables

    cfg = cfg.replace(max_seq_len=positions)
    return cfg, {**params, "rope": make_rope_tables(cfg, positions,
                                                     device=params["final_norm"].device)}


def cp_prompt(torch, cfg, device):
    """The cp sub-phase's prompt: CP_PROMPT tokens from a generator seeded 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (1, CP_PROMPT), generator=gen, device=device)


def pp_cp_rank(torch, cfg, full, rank: int, prompt) -> dict:
    """Phase tp's pp and cp sub-phases on this rank (`tp_rank`), on the whole
    8b-w4a8 tree ``full``. pp 2 × dp 1 (16 layers a stage): the 512-token
    prefill into an int8 cache against a one-process `forward` of the same
    tree in this process (logits, and this stage's layers of every cache
    tensor, bit for bit or not), `generate` for `PP_STEPS` greedy steps
    through the pipeline forward, and the engine (dense int8, the pipeline
    forward and its cache) on `serve_workload`'s first `TP_SERVE_REQUESTS`
    requests at SERVE_LAYERS["serve"] layers (rank 0's, broadcast). cp 2:
    `context_parallel_prefill` of a CP_PROMPT-token prompt into a
    CP_CACHE-position int8 cache (rank 0 also runs the one-process
    `forward`: its last logits and layer 0's codes and scales), `generate`
    with the context-parallel mesh, and the engine with it (threshold
    CP_THRESHOLD). Launches, wall seconds and collectives of each run."""
    import importlib
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.parallel import (
        context_parallel_prefill,
        make_grid_mesh,
        make_pipeline_forward,
        make_pp_mesh,
        shard_cache_pp,
        shard_params_pp,
    )
    from metalchat_tpu_torch.parallel.multihost import broadcast_requests

    gm = importlib.import_module("metalchat_tpu_torch.engine.generate")
    dev = full["final_norm"].device
    out = {}

    # -- pp 2 x dp 1 ------------------------------------------------------------
    mesh = make_pp_mesh(pp=2)
    stage, per = mesh.index("pp"), cfg.num_layers // 2
    local = shard_params_pp(full, mesh)
    pipe = make_pipeline_forward(cfg, mesh)

    def int8(c, rows, positions=None):
        return QuantizedKVCache.create(c, rows, positions or c.max_seq_len, device=dev)

    cache = shard_cache_pp(int8(cfg, 1), mesh)
    (logits, _), counts, secs, moves = timed_run(torch, lambda: pipe(local, cache, prompt, 0),
                                                 mesh)
    ref_cache = int8(cfg, 1)
    ref, _, ref_s, _ = timed_run(torch, lambda: forward(full, ref_cache, prompt, 0, cfg)[0])
    mine = slice(stage * per, (stage + 1) * per)
    out["pp_prefill"] = {
        "logits_equal": bool(torch.equal(logits, ref)),
        "share": ((logits - ref).abs() / logit_limit(ref)).max().item(),
        "cache_equal": {n: bool(torch.equal(getattr(cache, n), getattr(ref_cache, n)[mine]))
                        for n in ("k", "v", "k_scale", "v_scale")},
        "counts": counts, "s": secs, "ref_s": ref_s, "moves": moves}
    del logits, ref, cache, ref_cache
    ids, counts, secs, moves = timed_run(torch, lambda: gm.generate(
        local, cfg, prompt, max_new_tokens=PP_STEPS + 1, cache=shard_cache_pp(int8(cfg, 1), mesh),
        forward_fn=pipe), mesh)
    out["pp_generate"] = {"ids": ids[0].cpu(), "counts": counts, "s": secs, "moves": moves}
    cfg8, full8 = first_layers((cfg, full), SERVE_LAYERS["serve"], "pp/cp serve", quiet=True)
    pipe8 = make_pipeline_forward(cfg8, mesh)
    engine = ContinuousBatchingEngine(
        shard_params_pp(full8, mesh), cfg8, forward_fn=pipe8,
        cache=shard_cache_pp(int8(cfg8, PP_CP_SERVE["max_slots"]), mesh), **PP_CP_SERVE)
    reqs = broadcast_requests(mesh, serve_workload(cfg8, TP_SERVE_REQUESTS, TP_SERVE_NEW)
                              if rank == 0 else None)
    done, counts, secs, moves = timed_run(torch, lambda: engine.run(reqs), mesh)
    out["pp_serve"] = {"streams": [(c.tokens, c.finished, c.error) for c in done.values()],
                       "counts": counts, "s": secs, "moves": moves,
                       "counters": dict(engine.counters), "shapes": dict(engine.prefill_shapes),
                       "prompts": [len(r.prompt) for r in reqs]}
    del local, engine, pipe, pipe8
    torch.cuda.empty_cache()

    # -- cp 2 -----------------------------------------------------------------------
    mesh = make_grid_mesh({"sp": 2})
    ccfg, cfull = with_rope(full, cfg, CP_CACHE)
    cprompt = cp_prompt(torch, ccfg, dev)
    cache = int8(ccfg, 1)
    (logits, _), counts, secs, moves = timed_run(torch, lambda: context_parallel_prefill(
        cfull, cache, cprompt, ccfg, mesh), mesh)
    res = {"prompt": cprompt.cpu(), "last": logits[0].float().cpu(), "counts": counts,
           "s": secs, "moves": moves}
    if rank == 0:
        ref_cache = int8(ccfg, 1)
        ref, _, res["ref_s"], _ = timed_run(
            torch, lambda: forward(cfull, ref_cache, cprompt, 0, ccfg)[0][0, -1])
        res["ref_last"] = ref.float().cpu()
        res["layer0_equal"] = {n: bool(torch.equal(getattr(cache, n)[0, ..., :CP_PROMPT],
                                                   getattr(ref_cache, n)[0, ..., :CP_PROMPT]))
                               for n in ("k", "v", "k_scale", "v_scale")}
        del ref_cache
    out["cp_prefill"] = res
    # The first layers' codes and scales over the prompt, for the pp × cp
    # sub-phase (`pp_x_cp_rank`).
    whole_cp = {n: getattr(cache, n)[:SERVE_LAYERS["serve"], 0, :, :CP_PROMPT].clone()
                for n in ("k", "v", "k_scale", "v_scale")}
    del cache
    captures = []
    with timed_captures(torch, gm, captures):
        ids, counts, secs, moves = timed_run(torch, lambda: gm.generate(
            cfull, ccfg, cprompt, max_new_tokens=PP_STEPS + 1, cache=int8(ccfg, 1),
            context_parallel_mesh=mesh), mesh)
    out["cp_generate"] = {"ids": ids[0].cpu(), "counts": counts, "s": secs, "moves": moves,
                          "captures": len(captures)}
    engine = ContinuousBatchingEngine(full8, cfg8, quantized_kv=True, context_parallel_mesh=mesh,
                                      context_parallel_threshold=CP_THRESHOLD, **PP_CP_SERVE)
    reqs = broadcast_requests(mesh, serve_workload(cfg8, TP_SERVE_REQUESTS, TP_SERVE_NEW)
                              if rank == 0 else None)
    done, counts, secs, moves = timed_run(torch, lambda: engine.run(reqs), mesh)
    out["cp_serve"] = {"streams": [(c.tokens, c.finished, c.error) for c in done.values()],
                       "counts": counts, "s": secs, "moves": moves,
                       "counters": dict(engine.counters), "shapes": dict(engine.prefill_shapes),
                       "cp_shapes": dict(engine.cp_prefill_shapes),
                       "captures": len(engine._graphs)}
    del engine
    out["pp_x_cp"] = pp_x_cp_rank(torch, ccfg, cfull, rank, cprompt, whole_cp)
    return out


def pp_x_cp_requests(torch, cfg, prompt) -> list:
    """The pp × cp sub-phase's requests: ``prompt`` (CP_PROMPT tokens), then
    prompts of PP_X_CP_SHORT tokens from a generator seeded 2, greedy,
    PP_X_CP_NEW tokens each."""
    from metalchat_tpu_torch.engine import Request

    gen = torch.Generator().manual_seed(2)
    prompts = [prompt[0].tolist()] + [
        torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist() for n in PP_X_CP_SHORT]
    return [Request(prompt=p, max_new_tokens=PP_X_CP_NEW) for p in prompts]


def pp_x_cp_rank(torch, cfg, full, rank: int, prompt, whole_cp) -> dict:
    """pp 2 × cp 2 on this rank and the other (`pp_cp_rank`), through the
    CLI's engine build (`cli.main.build_serve_engine`: the pipeline forward,
    the stage's dense int8 cache of CP_CACHE positions, the cp mesh) on
    ``full`` (the CP_CACHE-row rope tree) cut to SERVE_LAYERS["serve"]
    layers. The stage-aware ring prefill of ``prompt`` alone first (its
    last logits, the stage's cache layers against ``whole_cp``: the whole
    tree's cp prefill's first layers over the same ranks, and the layer
    hand-offs), then the engine on `pp_x_cp_requests` (rank 0's,
    broadcast): streams, launches, collectives, and the long prompt's slot
    of the stage's cache against ``whole_cp``. Seconds of each and of the
    whole sub-phase."""
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.cli.main import build_serve_engine
    from metalchat_tpu_torch.parallel import context_parallel_prefill, shard_cache_pp
    from metalchat_tpu_torch.parallel.multihost import broadcast_requests

    t0 = time.perf_counter()
    cfg8, full8 = first_layers((cfg, full), SERVE_LAYERS["serve"], "pp x cp", quiet=True)
    engine, grid = build_serve_engine(
        full8, cfg8, pp=2, cp=2, slots=PP_CP_SERVE["max_slots"], max_seq_len=CP_CACHE,
        quantized_kv=True, burst=PP_CP_SERVE["decode_burst"])
    del full8
    stages, sp = engine.forward_fn.stages, engine.cp_mesh
    stage, per = stages.index("pp"), cfg8.num_layers // 2
    mine = slice(stage * per, (stage + 1) * per)
    names = ("k", "v", "k_scale", "v_scale")
    n = prompt.shape[1]
    cache = shard_cache_pp(QuantizedKVCache.create(cfg8, 1, CP_CACHE, device=prompt.device),
                           stages)
    (logits, _), counts, secs, moves = timed_run(torch, lambda: context_parallel_prefill(
        engine.params, cache, prompt, cfg8, sp, stages=stages), sp)
    res = {"last": logits[0].float().cpu(), "counts": counts, "s": secs, "moves": moves,
           "cache_equal": {k: bool(torch.equal(getattr(cache, k)[:, 0, :, :n],
                                               whole_cp[k][mine])) for k in names},
           "stage_layers": {k: getattr(v, "q", v).shape[0]
                            for k, v in engine.params["layers"].items()}}
    del cache, logits
    reqs = broadcast_requests(grid, pp_x_cp_requests(torch, cfg8, prompt.cpu())
                              if rank == 0 else None)
    before = dict(stages.counts)
    done, counts, secs, moves = timed_run(torch, lambda: engine.run(reqs), sp)
    for k, v in stages.counts.items():  # the pipeline's moves beside the ring's
        if v != before.get(k, 0):
            moves[k] = moves.get(k, 0) + v - before.get(k, 0)
    slot = PP_CP_SERVE["max_slots"] - 1  # the first request admitted (`_admit`)
    res["serve"] = {"streams": [(c.tokens, c.finished, c.error) for c in done.values()],
                    "counts": counts, "s": secs, "moves": moves,
                    "counters": dict(engine.counters), "shapes": dict(engine.prefill_shapes),
                    "cp_shapes": dict(engine.cp_prefill_shapes), "captures": len(engine._graphs),
                    "cache_equal": {k: bool(torch.equal(
                        getattr(engine.cache, k)[:, slot, :, :n], whole_cp[k][mine]))
                        for k in names}}
    res["sub_phase_s"] = time.perf_counter() - t0
    return res


def tp_launches(cfg, steps: int, prefill_calls: int, attention: str):
    """The launches of `steps` tensor-parallel decode steps (one matvec a
    fused projection a layer and the lm_head: 129 at the 8B, one
    ``attention`` a layer) and `prefill_calls` prompt windows of over 16
    tokens (flash a layer); every other kernel none."""
    L = cfg.num_layers
    return {"a8_matvec": (4 * L + 1) * steps, "a8_quantize": (4 * L + 1) * steps,
            attention: L * steps, "flash_attention": L * prefill_calls}


def phase_tp(sm: Smoke, main, smi: str):
    """Tensor-parallel decode and serving, `TP_RANKS` ranks on one card over
    `TP_BACKEND` (`tp_rank`), held against a one-process run of the same
    tree (main's 8b-w4a8 params; every rank's tree digest must equal it):
    the 512-token prefill's logits within `check_logits`'s limit (and
    whether bit-equal), layer 0's K/V codes and scales after the first step
    bit-equal, the first step's logits within relative L2
    `TP_STEP_REL_L2`, `generate`'s ids equal on every rank (and to the
    greedy loop's first two), the ids against the one-process run
    reported; launches exact per rank; no step captured. Then the engine's streams equal on every
    rank, every request finished, launches exact."""
    torch = sm.torch
    import tempfile

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import launch_counts

    cfg, params, _, _, _, prompt = main
    print(f"tp: {TP_LABEL} ({TP_BACKEND} asked for explicitly: NCCL refuses two ranks "
          "on one device); each rank's step runs eagerly (collectives between the "
          "kernels)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_ranks(sm, "tp", tp_rank, TP_RANKS, TP_TIMEOUT_S, tmp)
    r0 = ranks[0]
    sm.expect(all(r["same_bytes"] for r in ranks), "tp: the ranks' trees differ")
    sm.expect(torch.equal(tree_digest(torch, params), r0["digest"]),
              "tp: the ranks' tree differs from main's 8b-w4a8 params")
    sm.expect(torch.equal(r0["prompt"], prompt.cpu()), "tp: the prompt differs from main's")

    # The one-process run of the same tree on this card.
    ref = tp_greedy(torch, lambda p, c, t, s: forward(p, c, t, s, cfg), params,
                    QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device="cuda"),
                    prompt, TP_STEPS)
    got = r0["greedy"]
    share = check_logits(sm, "tp prefill logits", got["prefill"], ref["prefill"])
    bit_equal = bool(torch.equal(got["prefill"], ref["prefill"]))
    whole0 = {n: torch.cat([r["greedy"]["layer0"][n] for r in ranks], dim=0)
              for n in ("k", "v", "k_scale", "v_scale")}
    for n, t in whole0.items():
        sm.exact(t, ref["layer0"][n], f"tp layer 0 {n} after the first step")
    rel = ((got["step1"] - ref["step1"]).norm() / ref["step1"].norm()).item()
    sm.expect(rel < TP_STEP_REL_L2, f"tp: first step's logits relative L2 {rel:.4g} "
              f">= {TP_STEP_REL_L2}")
    ids = r0["generate_ids"]
    for r in ranks:
        sm.exact(r["generate_ids"], ids, "tp: generate's ids rank 0 vs another rank")
        sm.exact(r["greedy"]["ids"], ids[:2], "tp: the greedy loop's ids vs generate's")
        sm.exact(r["greedy"]["prefill"], got["prefill"],
                 "tp: prefill logits rank 0 vs another rank")
        sm.expect(r["generate_captures"] == 0 and r["serve_captures"] == 0,
                  "tp: a step was captured")
    same = int((ids == ref["ids"]).sum())
    first_part = next((i for i, (a, b) in enumerate(zip(ids.tolist(), ref["ids"].tolist()))
                       if a != b), None)
    # Launches, per rank.
    want = {**dict.fromkeys(launch_counts(), 0)}
    for r in ranks:
        g = r["greedy"]
        sm.expect(g["prefill_counts"] == {**want, **tp_launches(cfg, 0, 1,
                                                                "decode_attention_update")},
                  f"tp: prefill launches {g['prefill_counts']}")
        sm.expect(g["step_counts"] == {**want, **tp_launches(cfg, 1, 0,
                                                             "decode_attention_update")},
                  f"tp: step launches {g['step_counts']}")
        sm.expect(r["generate_counts"] == {**want, **tp_launches(cfg, TP_STEPS, 1,
                                                                 "decode_attention_update")},
                  f"tp: generate launches {r['generate_counts']}")
    print(f"tp generate ({TP_LABEL}; 8b-w4a8, all {cfg.num_layers} layers, each rank "
          f"{r0['local_bytes'] / 1e9:.3f} GB of local weights, set-up {r0['setup_s']:.1f} s): "
          f"prefill logits {share:.4f} of check_logits' limit, bit-equal {bit_equal}; layer "
          f"0's K/V codes and scales after the first step bit-equal; first step's logits "
          f"relative L2 {rel:.4g}; ids {same} of {len(ref['ids'])} equal to the one-process "
          f"run's (first parting at {first_part}); ranks' ids equal; generate "
          f"{1e3 * r0['generate_s']:.2f} ms for the prefill ({1e3 * got['prefill_s']:.2f} ms "
          f"alone; one process {1e3 * ref['prefill_s']:.2f}) and {TP_STEPS} eager steps: "
          f"{TP_STEPS / (r0['generate_s'] - got['prefill_s']):.2f} tok/s (the one-process "
          f"eager loop {1e3 * ref['steps_s'] / TP_STEPS:.2f} ms a step); launches a rank: "
          f"prefill {got['prefill_counts']}, generate {r0['generate_counts']}; captured "
          f"steps {r0['generate_captures']} (every step eager)",
          flush=True)

    # The engine.
    streams = [r["serve_streams"] for r in ranks]
    for r in ranks[1:]:
        sm.expect(r["serve_streams"] == streams[0], "tp serve: streams differ across ranks")
    sm.expect(len(streams[0]) == TP_SERVE_REQUESTS and all(
        f and e is None and len(t) == TP_SERVE_NEW for t, f, e in streams[0]),
        f"tp serve: unfinished or short completions {[(len(t), f, e) for t, f, e in streams[0]]}")
    for r in ranks:
        c = r["serve_counters"]
        # A one-token prompt window takes the decode step too.
        steps = c["decode_steps"] + sum(n for (b, s), n in r["serve_shapes"].items()
                                        if s == 1)
        windows = sum(n for (b, s), n in r["serve_shapes"].items() if s > 16)
        expect = {**want, **tp_launches(cfg, steps, windows,
                                        "paged_decode_attention_update")}
        sm.expect(r["serve_counts"] == expect,
                  f"tp serve: launches {r['serve_counts']} != {expect}")
    c = r0["serve_counters"]
    tokens = sum(len(t) for t, _, _ in streams[0])
    print(f"tp serve ({TP_LABEL}; MultiHostEngine paged, pages of {TP_SERVE['page_size']}, "
          f"{TP_SERVE_REQUESTS} requests of {min(r0['serve_prompts'])}-"
          f"{max(r0['serve_prompts'])} prompt tokens, {TP_SERVE_NEW} greedy tokens each, "
          f"{TP_SERVE['max_slots']} slots, chunks of {TP_SERVE['prefill_chunk']}): "
          f"{tokens / r0['serve_s']:.2f} tok/s over {r0['serve_s']:.2f} s, streams equal on "
          f"every rank; counters {c} (captured bursts {r0['serve_captures']}); prompt "
          f"windows {r0['serve_shapes']}; launches a rank "
          f"{r0['serve_counts']}; collectives a rank over the phase {r0['collectives']}",
          flush=True)
    pp_cp = check_pp_cp(sm, main, ranks)
    quality_tp_check(sm)
    print(f"tp: phase wall {wall:.1f} s for the ranks ({TP_LABEL}; {smi.splitlines()[0]}); "
          "these times are functional numbers, not a tensor-parallel, pipeline or "
          "context-parallel speed figure", flush=True)
    return {"generate": r0["generate_counts"], "serve": r0["serve_counts"], **pp_cp}


QTP_BATCH, QTP_SEQ, QTP_WINDOW = 4, 128, 16


def quality_tp_check(sm: Smoke) -> None:
    """quality-tp: `tools.quality_tp` on the card at ``--batch 4 --seq 128``
    (the fixture's kv-heads repeated for tp 2): the one-process decode-path
    perplexity (W4A8, f32) within PPL_RTOL of the CPU's, then the tool's two
    gloo ranks on the one card and the tp-2 change printed (functional
    numbers, as for every gloo phase)."""
    import numpy as np
    from pathlib import Path

    from metalchat_tpu_torch.tools import quality_tp as qt

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    t0 = time.perf_counter()
    logs = []
    got = qt.measure(fixture, QTP_BATCH, QTP_SEQ, QTP_WINDOW, "cuda", log=logs.append)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, cfg, ev = qt.load_w4a8(fixture, QTP_SEQ, "cpu")
    want = float(np.exp(qt.single_nll(qparams, cfg, qt.eval_batch(ev, QTP_BATCH, QTP_SEQ),
                                      QTP_WINDOW)))
    cpu_s = time.perf_counter() - t0
    rel = abs(got["decode_path_ppl_single"] - want) / want
    print(f"quality-tp (tools/quality_tp.py, batch {QTP_BATCH} x seq {QTP_SEQ}, windows of "
          f"{QTP_WINDOW}, W4A8 f32, {cfg.num_kv_heads} kv-heads after the repeat): one "
          f"process {got['decode_path_ppl_single']:.5f} on the card, CPU {want:.5f} "
          f"({rel:.3g} apart, limit {PPL_RTOL}); tp 2 (2 gloo ranks on one card) "
          f"{got['decode_path_ppl_tp2']:.5f}, {got['tp2_vs_single_pct']:+.4f}% against one "
          f"process; {logs[-1]}; card {card_s:.1f} s, CPU {cpu_s:.1f} s", flush=True)
    sm.expect(rel <= PPL_RTOL, f"quality-tp: one process's ppl {got} against the CPU's {want}")
    sm.expect(math.isfinite(got["decode_path_ppl_tp2"]), f"quality-tp: {got}")


def pp_cp_serve_launches(cfg, run: dict, per_rank_layers: int, attention: str,
                         matvec: bool) -> dict:
    """The launches an engine run (`pp_cp_rank`'s ``pp_serve`` or
    ``cp_serve``) must show on one rank: flash a layer for every prompt
    window of over 16 tokens; for every decode step, and every window of
    at most 16 tokens, one ``attention`` launch a layer and, on the decode
    route (``matvec``), one fused matvec a projection and the lm_head."""
    from metalchat_tpu_torch.ops import launch_counts

    short = sum(n for (b, s), n in run["shapes"].items() if s <= 16)
    windows = sum(n for (b, s), n in run["shapes"].items() if s > 16)
    steps = run["counters"]["decode_steps"] + short
    want = {**dict.fromkeys(launch_counts(), 0), "flash_attention": per_rank_layers * windows,
            attention: per_rank_layers * steps}
    if matvec:
        a8 = (4 * cfg.num_layers + 1) * steps
        want.update(a8_matvec=a8, a8_quantize=a8)
    return want


def check_pp_cp(sm: Smoke, main, ranks) -> dict:
    """Phase tp's pp and cp sub-phases (`pp_cp_rank`), held here against
    one-process runs of main's tree on this card: pp's prefill bit for bit
    against `forward` (checked on each rank), `generate`'s ids on both
    ranks equal to a greedy loop of `forward(fast_decode=False)` (the layer
    route, which a stage runs), the engine's streams on both ranks equal to
    the one-process engine given that forward (`eager_burst_engine`); cp's
    last logits within `check_logits`'s limit of the one-process prefill's,
    layer 0's codes and scales bit for bit, `generate`'s ids on both ranks
    equal, and against the one-process `generate` (int8 cache) a parting
    only at a near tie (`near_tie`), the engine's streams equal on both
    ranks. Launches exact on each rank. Returns the runs' launches by
    path."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import launch_counts

    cfg, params, _, _, _, prompt = main
    dev = params["final_norm"].device
    zero = dict.fromkeys(launch_counts(), 0)
    L, per = cfg.num_layers, cfg.num_layers // 2
    r0 = ranks[0]

    # -- pp -------------------------------------------------------------------
    for stage, r in enumerate(ranks):
        pre = r["pp_prefill"]
        sm.expect(pre["share"] <= 1.0, f"pp stage {stage}: prefill logits at {pre['share']:.4g} "
                  "of check_logits' limit")
        sm.expect(pre["logits_equal"] and all(pre["cache_equal"].values()),
                  f"pp stage {stage}: prefill against the one-process forward: logits "
                  f"bit-equal {pre['logits_equal']}, cache {pre['cache_equal']}")
        sm.expect(pre["counts"] == {**zero, "flash_attention": per},
                  f"pp stage {stage}: prefill launches {pre['counts']}")
        g = r["pp_generate"]
        sm.expect(g["counts"] == {**zero, "flash_attention": per,
                                  "decode_attention_layer": per * PP_STEPS},
                  f"pp stage {stage}: generate launches {g['counts']}")
        sm.exact(g["ids"], r0["pp_generate"]["ids"], "pp: generate's ids stage 0 vs stage 1")
    ref = tp_greedy(torch, lambda p, c, t, s: forward(p, c, t, s, cfg, fast_decode=False),
                    params, QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device=dev),
                    prompt, PP_STEPS)
    sm.exact(r0["pp_generate"]["ids"], ref["ids"],
             "pp: generate's ids against the one-process layer-route loop")
    cfg8, params8 = first_layers((cfg, params), SERVE_LAYERS["serve"], "pp/cp serve")
    streams = [r["pp_serve"]["streams"] for r in ranks]
    sm.expect(streams[1] == streams[0], "pp serve: streams differ across stages")
    sm.expect(all(f and e is None and len(t) == TP_SERVE_NEW for t, f, e in streams[0])
              and len(streams[0]) == TP_SERVE_REQUESTS,
              "pp serve: unfinished or short completions "
              f"{[(len(t), f, e) for t, f, e in streams[0]]}")
    one = eager_burst_engine(params8, cfg8, quantized_kv=True,
                             forward_fn=lambda p, c, t, s: forward(p, c, t, s, cfg8,
                                                                   fast_decode=False),
                             **PP_CP_SERVE)
    t = time.perf_counter()
    done = one.run(serve_workload(cfg8, TP_SERVE_REQUESTS, TP_SERVE_NEW))
    one_s = time.perf_counter() - t
    sm.expect([c.tokens for c in done.values()] == [t_ for t_, _, _ in streams[0]],
              "pp serve: streams differ from the one-process engine's")
    for stage, r in enumerate(ranks):
        want = pp_cp_serve_launches(cfg8, r["pp_serve"], SERVE_LAYERS["serve"] // 2,
                                    "decode_attention_layer", matvec=False)
        sm.expect(r["pp_serve"]["counts"] == want,
                  f"pp serve stage {stage}: launches {r['pp_serve']['counts']} != {want}")
    pre, g, sv = r0["pp_prefill"], r0["pp_generate"], r0["pp_serve"]
    step_moves = {k: (v - pre["moves"].get(k, 0)) / PP_STEPS for k, v in g["moves"].items()}
    tokens = sum(len(t_) for t_, _, _ in streams[0])
    print(f"tp pp ({TP_LABEL}; pp 2 x dp 1, {per} of {L} layers a stage, int8 KV; times "
          f"are functional numbers over gloo, not a pipeline speed figure): the "
          f"{prompt.shape[1]}-token prefill bit-equal to the one-process forward's (logits and "
          f"every layer's codes and scales, both stages) in {1e3 * pre['s']:.2f} ms (one "
          f"process {1e3 * pre['ref_s']:.2f} ms); generate {PP_STEPS} greedy steps: ids equal on "
          f"both stages and to the one-process layer-route loop, {1e3 * g['s']:.2f} ms with "
          f"the prefill ({1e3 * (g['s'] - pre['s']) / PP_STEPS:.2f} ms a step; the one-process "
          f"loop {1e3 * ref['steps_s'] / PP_STEPS:.2f}); launches a stage: prefill "
          f"{pre['counts']}, generate {g['counts']}; collectives: a prefill {pre['moves']}, "
          f"a step {step_moves}", flush=True)
    print(f"tp pp serve (functional numbers over gloo; the pipeline forward in the engine, "
          f"dense int8, {cfg8.num_layers} layers, {SERVE_LAYERS['serve'] // 2} a stage; "
          f"{TP_SERVE_REQUESTS} requests of {min(sv['prompts'])}-{max(sv['prompts'])} tokens, "
          f"{TP_SERVE_NEW} greedy tokens): "
          f"{tokens / sv['s']:.2f} tok/s over {sv['s']:.2f} s (the one-process eager engine "
          f"{one_s:.2f} s); streams equal on both stages and to the one-process engine's; "
          f"counters {sv['counters']}; windows {sv['shapes']}; launches a stage {sv['counts']}; "
          f"collectives {sv['moves']}", flush=True)

    # -- cp -------------------------------------------------------------------
    ccfg, cparams = with_rope(params, cfg, CP_CACHE)
    cprompt = cp_prompt(torch, ccfg, dev)
    cp = r0["cp_prefill"]
    for rank, r in enumerate(ranks):
        sm.exact(r["cp_prefill"]["prompt"], cprompt.cpu(), f"cp rank {rank}: the prompt")
        sm.exact(r["cp_prefill"]["last"], cp["last"], f"cp rank {rank}: the last logits")
        sm.expect(r["cp_prefill"]["counts"] == zero,
                  f"cp rank {rank}: prefill launches {r['cp_prefill']['counts']}")
    share = check_logits(sm, "cp prefill's last logits", cp["last"], cp["ref_last"])
    sm.expect(all(cp["layer0_equal"].values()),
              f"cp: layer 0's cache against the one-process forward's {cp['layer0_equal']}")
    ids = r0["cp_generate"]["ids"]
    for rank, r in enumerate(ranks):
        g = r["cp_generate"]
        sm.exact(g["ids"], ids, f"cp rank {rank}: generate's ids against rank 0's")
        a8 = (4 * L + 1) * PP_STEPS
        sm.expect(g["counts"] == {**zero, "a8_matvec": a8, "a8_quantize": a8,
                                  "decode_attention_update": L * PP_STEPS},
                  f"cp rank {rank}: generate launches {g['counts']}")
    t = time.perf_counter()
    ref_ids = generate(cparams, ccfg, cprompt, max_new_tokens=PP_STEPS + 1, quantized_kv=True,
                       max_seq_len=CP_CACHE)[0].cpu()
    one_s = time.perf_counter() - t
    parting = near_tie(sm, "cp generate", cparams, ccfg, cprompt, ref_ids.tolist(),
                       ids.tolist(), quantized=True)
    streams = [r["cp_serve"]["streams"] for r in ranks]
    sm.expect(streams[1] == streams[0], "cp serve: streams differ across ranks")
    sm.expect(all(f and e is None and len(t_) == TP_SERVE_NEW for t_, f, e in streams[0])
              and len(streams[0]) == TP_SERVE_REQUESTS,
              "cp serve: unfinished or short completions "
              f"{[(len(t_), f, e) for t_, f, e in streams[0]]}")
    long = sum(len(r.prompt) >= CP_THRESHOLD
               for r in serve_workload(cfg8, TP_SERVE_REQUESTS, TP_SERVE_NEW))
    for rank, r in enumerate(ranks):
        sv = r["cp_serve"]
        sm.expect(sum(sv["cp_shapes"].values()) == long,
                  f"cp serve rank {rank}: {sv['cp_shapes']} ring prefills, {long} prompts of "
                  f"{CP_THRESHOLD} tokens or more")
        want = pp_cp_serve_launches(cfg8, sv, cfg8.num_layers, "decode_attention_update",
                                    matvec=True)
        sm.expect(sv["counts"] == want, f"cp serve rank {rank}: launches {sv['counts']} != {want}")
    g, sv = r0["cp_generate"], r0["cp_serve"]
    tokens = sum(len(t_) for t_, _, _ in streams[0])
    print(f"tp cp ({TP_LABEL}; sp 2, all {L} layers, int8 KV of {CP_CACHE}; times are "
          f"functional numbers over gloo, not a context-parallel speed figure): the "
          f"{CP_PROMPT}-token context-parallel prefill in {1e3 * cp['s']:.2f} ms (one "
          f"process, flash: {1e3 * cp['ref_s']:.2f} ms), its last logits {share:.4f} of "
          f"check_logits' limit (max abs err "
          f"{(cp['last'] - cp['ref_last']).abs().max().item()}), layer 0's codes "
          f"and scales bit-equal to the one-process forward's, launches {cp['counts']} (no "
          f"kernel: the products are torch._int_mm, the attention the plain ring), "
          f"collectives {cp['moves']}; generate {PP_STEPS} steps: ids equal on both ranks, "
          f"against the one-process generate: {parting}; {1e3 * g['s']:.2f} ms with the "
          f"prefill (one process {1e3 * one_s:.2f}), captured steps {g['captures']}, launches "
          f"{g['counts']}", flush=True)
    print(f"tp cp serve (functional numbers over gloo; the engine with the cp mesh, dense "
          f"int8, threshold {CP_THRESHOLD}, {cfg8.num_layers} layers): "
          f"{tokens / sv['s']:.2f} tok/s over {sv['s']:.2f} s; streams equal on both ranks; "
          f"{sum(sv['cp_shapes'].values())} prompts through the ring {sv['cp_shapes']}, "
          f"other windows {sv['shapes']}; counters {sv['counters']}; "
          f"captured bursts {sv['captures']}; launches a rank {sv['counts']}; collectives "
          f"{sv['moves']}", flush=True)
    x = check_pp_x_cp(sm, cparams, ccfg, cprompt, ranks)
    return {"pp_generate": r0["pp_generate"]["counts"], "pp_serve": r0["pp_serve"]["counts"],
            "cp_generate": r0["cp_generate"]["counts"], "cp_serve": r0["cp_serve"]["counts"],
            "pp_x_cp_serve": x}


def check_pp_x_cp(sm: Smoke, cparams, ccfg, cprompt, ranks) -> dict:
    """Phase tp's pp 2 × cp 2 sub-phase (`pp_x_cp_rank`), held against one
    process's layer-route engine on the same tree (main's, CP_CACHE rope
    rows, SERVE_LAYERS["serve"] layers): the ring prefill's last logits
    within `check_logits`' limit of one process's `forward(fast_decode=
    False)` and equal on both ranks; each stage's cache layers (the direct
    prefill's and the engine's slot) bit for bit those layers of the
    whole-tree cp prefill over the same ranks; one layer hand-off a layer;
    each rank left with its stage's layers only; the engine's streams
    equal on both stages and to the one-process engine's (`eager_burst_
    engine` with that forward) or parted at a near tie (`engine_parting` on
    the layer route); the long prompt through one ring prefill; launches
    exact a stage (row 6 a layer a step, row 4 a layer a chunked window,
    nothing in the ring). Returns rank 0's engine launches."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import launch_counts

    zero = dict.fromkeys(launch_counts(), 0)
    cfg8, params8 = first_layers((ccfg, cparams), SERVE_LAYERS["serve"], "pp x cp")
    L, per = cfg8.num_layers, cfg8.num_layers // 2
    dev = cprompt.device

    def layer_route(p, c, t, s):
        return forward(p, c, t, s, cfg8, fast_decode=False)

    ref = layer_route(params8, QuantizedKVCache.create(cfg8, 1, CP_CACHE, device=dev), cprompt,
                      0)[0][0, -1].float().cpu()
    reqs = pp_x_cp_requests(torch, cfg8, cprompt.cpu())
    one = eager_burst_engine(params8, cfg8, quantized_kv=True, max_seq_len=CP_CACHE,
                             forward_fn=layer_route, **PP_CP_SERVE)
    t = time.perf_counter()
    done = one.run(reqs)
    one_s = time.perf_counter() - t
    want = [c.tokens for c in done.values()]
    r0 = ranks[0]["pp_x_cp"]
    for stage, r in enumerate(ranks):
        x = r["pp_x_cp"]
        sv = x["serve"]
        sm.exact(x["last"], r0["last"], f"pp x cp stage {stage}: the ring prefill's last logits")
        sm.expect(all(x["cache_equal"].values()) and all(sv["cache_equal"].values()),
                  f"pp x cp stage {stage}: its cache layers against the whole-tree cp "
                  f"prefill's: the prefill {x['cache_equal']}, the engine {sv['cache_equal']}")
        sm.expect(x["counts"] == zero, f"pp x cp stage {stage}: prefill launches {x['counts']}")
        sm.expect(x["moves"].get("layer_broadcast_sp") == L,
                  f"pp x cp stage {stage}: layer hand-offs {x['moves']}, {L} layers")
        sm.expect(set(x["stage_layers"].values()) == {per},
                  f"pp x cp stage {stage}: layers held after the prefill {x['stage_layers']}")
        sm.expect(sv["cp_shapes"] == {(1, CP_PROMPT): 1} and sv["captures"] == 0,
                  f"pp x cp stage {stage}: ring prefills {sv['cp_shapes']}, captures "
                  f"{sv['captures']}")
        sm.expect(sv["streams"] == r0["serve"]["streams"],
                  "pp x cp serve: streams differ across stages")
        launches = pp_cp_serve_launches(cfg8, sv, per, "decode_attention_layer", matvec=False)
        sm.expect(sv["counts"] == launches,
                  f"pp x cp serve stage {stage}: launches {sv['counts']} != {launches}")
    streams = r0["serve"]["streams"]
    sm.expect(len(streams) == len(reqs) and all(
        f and e is None and len(t_) == PP_X_CP_NEW for t_, f, e in streams),
        "pp x cp serve: unfinished or short completions "
        f"{[(len(t_), f, e) for t_, f, e in streams]}")
    share = check_logits(sm, "pp x cp prefill's last logits", r0["last"], ref)
    partings = [engine_parting(sm, f"pp x cp request {i}", params8, cfg8, list(req.prompt), w,
                               got, fast_decode=False)
                for i, (req, w, (got, _, _)) in enumerate(zip(reqs, want, streams))]
    sv = r0["serve"]
    print(f"tp pp x cp ({TP_LABEL}; pp 2 x cp 2 on the same two ranks through "
          f"cli.main.build_serve_engine, {L} layers, {per} a stage, int8 KV of {CP_CACHE}; "
          f"functional numbers over gloo): the {CP_PROMPT}-token ring prefill over the stages' "
          f"layers in {1e3 * r0['s']:.2f} ms, its last logits {share:.4f} of check_logits' "
          f"limit (max abs err {(r0['last'] - ref).abs().max().item()}) of one process's "
          f"layer route, each stage's cache layers bit-equal to the whole-tree cp prefill's; "
          f"collectives a rank {r0['moves']} (layer hand-offs "
          f"{r0['moves'].get('layer_broadcast_sp')}); the engine on {len(reqs)} requests of "
          f"{[len(q.prompt) for q in reqs]} tokens, {PP_X_CP_NEW} greedy each: "
          f"{sum(len(t_) for t_, _, _ in streams) / sv['s']:.2f} tok/s over {sv['s']:.2f} s (one "
          f"process's layer-route engine {one_s:.2f} s); streams equal on both stages, against "
          f"one process: {partings}; ring prefills {sv['cp_shapes']}, other windows "
          f"{sv['shapes']}; counters {sv['counters']}; launches a stage {sv['counts']}; "
          f"collectives {sv['moves']}; the sub-phase {r0['sub_phase_s']:.2f} s a rank",
          flush=True)
    return sv["counts"]


SPEC_DRAFT = 4    # n_draft: 3 drafts and the target's verify of 4 tokens a round
SPEC_NEW = 32
SPEC_FORCED = (3, 0)  # _force_accept in the turns: every draft, then none


# -- the mesh's ep and dp axes: MoE under tp and over ep, MultiHostServer ------

# Mixtral-8x7B at its published widths cut to 8 of 32 layers (each rank makes
# the whole cut, 5.7 GB of weights, and keeps its shards).
MOE_TP_CUT = dict(num_layers=8)
MOE_TP_RANKS, MOE_TP_STEPS, MOE_TP_TIMED = 2, 16, 4
# MultiHostServer on make_hybrid_mesh(dcn_dp=2, tp=2): main's 8b-w4a8 tree,
# prompts of mixed lengths (two rounds of one length each, the second padded
# by a copy of its real row) whose caches of 128 and 256 positions take row
# 6 on the layer route's one-token steps. 12 new tokens a request keep the
# phase inside the script's budget (28 took 73.6 s of an 871.9-s run on an
# H100 host about 28% slower than the one before).
MH_RANKS, MH_BATCH, MH_NEW = 4, 2, 12
MH_PROMPT_LENS = (116, 116, 244)
MH_TIMEOUT_S = 420
# Then MultiHostEngine on the same mesh and tree: the tensor-parallel decode
# (W4A8 takes it), an int8 dense cache of 4 slots (2 a dp row), bursts of 4,
# the same requests.
MH_ENGINE = dict(max_slots=4, max_seq_len=256, quantized_kv=True, decode_burst=4,
                 prefill_chunk=256)


def moe_tp_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase tp-moe, a process of its own. It joins the gloo
    group, makes the seeded Mixtral cut (`make_mixtral`, MOE_TP_CUT) on the
    card, checks that every rank holds the same bytes, shards it for (a) tp
    2 and (b) ep 2 (`shard_params`) and frees the whole tree. (a): one
    greedy step (`tp_greedy`) and `generate` for MOE_TP_STEPS steps through
    `tp_decode_forward_fn` (MoE on the tensor-parallel decode: the indexed
    matvec at F/tp). (b): the same through the forward the engine picks for
    an ep mesh (`spmd_forward_fn`: the sharded layer route), and its
    prefill's routing recorded (`recorded_routing`) in one more prefill.
    `generate` runs first, so that `tp_greedy`'s prefill and MOE_TP_TIMED
    steps are timed warm. Saves what it saw to ``out_dir/rank{rank}.pt``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    import importlib

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.parallel import (
        initialize,
        make_mesh,
        shard_cache,
        shard_params,
        shutdown,
        spmd_forward_fn,
        tp_decode_forward_fn,
    )

    gm = importlib.import_module("metalchat_tpu_torch.engine.generate")
    initialize(f"file://{store}", MOE_TP_RANKS, rank, backend=TP_BACKEND,
               timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    try:
        meshes = {"tp": make_mesh(tp=MOE_TP_RANKS), "ep": make_mesh(tp=1, ep=MOE_TP_RANKS)}
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        cfg, full = make_mixtral(Smoke(torch), "cuda", **MOE_TP_CUT)
        out = same_tree(torch, full)
        local = {n: shard_params(full, cfg, m) for n, m in meshes.items()}
        del full
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        out.update(setup_s=time.perf_counter() - t0, memory=torch.cuda.memory_allocated(),
                   local_bytes={n: weight_bytes(p) for n, p in local.items()})
        prompt = seeded_prompt(torch, cfg, dev)
        out["prompt"] = prompt.cpu()
        for name, mesh in meshes.items():
            params = local[name]
            fwd = (tp_decode_forward_fn if name == "tp" else spmd_forward_fn)(params, cfg, mesh)

            def cache():
                return shard_cache(QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device=dev),
                                   mesh)

            before = dict(mesh.counts)
            reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids = gm.generate(params, cfg, prompt, max_new_tokens=MOE_TP_STEPS + 1,
                              cache=cache(), forward_fn=fwd)
            torch.cuda.synchronize()
            res = {"route": fwd.__qualname__.split(".")[0], "generate_ids": ids[0].cpu(),
                   "generate_counts": launch_counts(), "generate_s": time.perf_counter() - t,
                   "collectives": {k: v - before.get(k, 0) for k, v in mesh.counts.items()}}
            res["greedy"] = tp_greedy(torch, fwd, params, cache(), prompt, MOE_TP_TIMED)
            if name == "ep":
                with recorded_routing(torch, []) as calls:
                    fwd(params, cache(), prompt, 0)
                res["routing"] = calls
            out[name] = res
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        shutdown()


def layer_route_parting(sm: Smoke, what: str, ref, got, held_prefill=None) -> str:
    """``got`` (ids [n]) against the one-process layer route's run ``ref``
    (`tp_greedy`): identical, or parted first at an
    index j where the one-process route's top two logits are ``ref``'s id
    and ``got``'s, within `check_logits`' limit of each other (a near tie
    that the expert sum's order breaks apart), or at the prefill's token
    where the one-process prefill given the sharded run's routing
    (``held_prefill``, its logits [S, V]) picks ``got``'s. Otherwise the
    phase fails."""
    torch = sm.torch
    ids = ref["ids"]
    diff = [i for i, (a, b) in enumerate(zip(got.tolist(), ids.tolist())) if a != b]
    if not diff:
        return "identical"
    j = diff[0]
    if j == 0 and held_prefill is not None and int(held_prefill[-1].argmax()) == int(got[0]):
        return ("parted at the prefill's token, which the one-process prefill given the "
                "sharded run's routing picks too")
    row = ref["last"][j]
    top = torch.topk(row, 2)
    gap = (top.values[0] - top.values[1]).item()
    limit = RTOL["bfloat16"] * top.values[0].abs().item() + LOGIT_SHARE * row.abs().max().item()
    sm.expect(top.indices.tolist() == [int(ids[j]), int(got[j])] and gap <= limit,
              f"{what}: ids part at index {j} (got {int(got[j])}, the one-process layer route "
              f"{int(ids[j])}; its top two {top.indices.tolist()}, gap {gap}, limit {limit}): "
              "not a near tie")
    return f"parted at index {j} of {len(ids)}, a near tie (top-2 gap {gap:.4g}, limit {limit:.4g})"


def moe_tp_launches(cfg, run: str, steps: int, prefills: int) -> dict:
    """The launches of `steps` one-token steps and `prefills` prompt windows
    of over 16 tokens on one rank: flash a layer a prefill; a step of (a)
    the tensor-parallel decode's matvec calls (`matvec_calls`: wqkv, wo and
    the lm_head at host indices, each routed (row, choice)'s three experts
    at a device index) and row 3 a layer, or of (b) the layer route row 6 a
    layer and no matvec."""
    from metalchat_tpu_torch.ops import launch_counts

    L = cfg.num_layers
    want = {**dict.fromkeys(launch_counts(), 0), "flash_attention": L * prefills}
    if run == "tp":
        want.update({k: n * steps for k, n in matvec_calls(cfg, 1).items()},
                    decode_attention_update=L * steps)
    else:
        want["decode_attention_layer"] = L * steps
    return want


def phase_tp_moe(sm: Smoke, smi: str):
    """MoE on the mesh, `MOE_TP_RANKS` ranks on one card over `TP_BACKEND`
    (`moe_tp_rank`), Mixtral-8x7B's widths cut as MOE_TP_CUT, W4A8, int8 KV,
    held against one-process runs of the same tree here (every rank's tree
    digest must equal it). (a) tp 2, MoE on the tensor-parallel decode: the
    512-token prefill's logits within `check_logits`' limit of the
    one-process fast route's (and whether bit-equal), layer 0's K/V codes
    and scales after the first step bit-equal, the first step's logits
    within relative L2 `TP_STEP_REL_L2`, `generate`'s ids equal on both
    ranks (and to the greedy loop's first MOE_TP_TIMED + 1). (b) ep 2, the
    sharded layer route: layer 0's K/V after the first step bit-equal to the
    one-process layer route's; the prefill within the limit of the
    one-process layer route's, or, where the ranks routed a token to other
    experts (a router near tie), of the one-process prefill given their
    routing (each such token printed with its gap); `generate`'s ids equal
    on both ranks and to a one-process loop of `forward(fast_decode=False)`,
    or parted at a near tie (`layer_route_parting`). Launches exact per
    rank (`moe_tp_launches`)."""
    torch = sm.torch
    import tempfile

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    cfg, params = make_mixtral(sm, "cuda", **MOE_TP_CUT)
    L = cfg.num_layers
    print(f"tp-moe: {MOE_TP_RANKS} ranks over {TP_BACKEND} on one card; each rank makes the "
          f"{L}-layer cut on the card, shards it for tp {MOE_TP_RANKS} and ep {MOE_TP_RANKS} "
          "and frees the whole tree", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_ranks(sm, "tp-moe", moe_tp_rank, MOE_TP_RANKS, TP_TIMEOUT_S, tmp)
    r0 = ranks[0]
    sm.expect(all(r["same_bytes"] for r in ranks), "tp-moe: the ranks' trees differ")
    sm.expect(torch.equal(tree_digest(torch, params), r0["digest"]),
              "tp-moe: the ranks' tree differs from this process's")
    prompt = seeded_prompt(torch, cfg, torch.device("cuda"))
    sm.expect(torch.equal(r0["prompt"], prompt.cpu()), "tp-moe: the prompt differs")

    def one_process(fast: bool):
        return tp_greedy(torch, lambda p, c, t, s: forward(p, c, t, s, cfg, fast_decode=fast),
                         params, QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device="cuda"),
                         prompt, MOE_TP_STEPS)

    forward(params, QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device="cuda"), prompt, 0,
            cfg)  # a warm-up, so that the times below are warm
    refs = {"tp": one_process(True)}
    with recorded_routing(torch, []) as ref_calls:
        refs["ep"] = one_process(False)
    out = {}
    for name, ref in refs.items():
        got = r0[name]["greedy"]
        label = f"tp-moe ({name} {MOE_TP_RANKS})"
        want, flips = ref["prefill"], []
        if name == "ep":  # a token the sharded run routed to other experts
            flips, held = held_to_routing(
                sm, f"{label} prefill", ref_calls[:L], r0[name]["routing"], L,
                lambda: forward(params, QuantizedKVCache.create(
                    cfg, 1, cfg.max_seq_len, device="cuda"), prompt, 0, cfg,
                    fast_decode=False)[0][0].float().cpu(), ("the ranks", "one process"))
            want = want if held is None else held
        share = check_logits(sm, f"{label} prefill logits", got["prefill"], want)
        bit_equal = bool(torch.equal(got["prefill"], want))
        ids = r0[name]["generate_ids"]
        for r in ranks:
            sm.exact(r[name]["generate_ids"], ids, f"{label}: generate's ids rank 0 vs another")
            sm.exact(r[name]["greedy"]["ids"], ids[:MOE_TP_TIMED + 1],
                     f"{label}: the greedy loop's ids vs generate's")
            sm.exact(r[name]["greedy"]["prefill"], got["prefill"],
                     f"{label}: prefill logits rank 0 vs another")
            g = r[name]["greedy"]
            sm.expect(g["prefill_counts"] == moe_tp_launches(cfg, name, 0, 1),
                      f"{label}: prefill launches {g['prefill_counts']}")
            sm.expect(g["step_counts"] == moe_tp_launches(cfg, name, MOE_TP_TIMED, 0),
                      f"{label}: step launches {g['step_counts']}")
            sm.expect(r[name]["generate_counts"] == moe_tp_launches(cfg, name, MOE_TP_STEPS, 1),
                      f"{label}: generate launches {r[name]['generate_counts']}")
        rel = ((got["step1"] - ref["step1"]).norm() / ref["step1"].norm()).item()
        if name == "tp":
            sm.expect(r0[name]["route"] == "tp_decode_forward_fn", f"{label}: route")
            whole0 = {n: torch.cat([r[name]["greedy"]["layer0"][n] for r in ranks], dim=0)
                      for n in ("k", "v", "k_scale", "v_scale")}
            for n, t in whole0.items():
                sm.exact(t, ref["layer0"][n], f"{label} layer 0 {n} after the first step")
            sm.expect(rel < TP_STEP_REL_L2, f"{label}: first step's logits relative L2 "
                      f"{rel:.4g} >= {TP_STEP_REL_L2}")
            same = int((ids == ref["ids"]).sum())
            against = f"{same} of {len(ids)} ids equal to the one-process fast route's"
        else:
            sm.expect(r0[name]["route"] == "layer_route_forward_fn", f"{label}: route")
            for n, t in got["layer0"].items():  # the heads are whole on an ep mesh
                sm.exact(t, ref["layer0"][n], f"{label} layer 0 {n} after the first step")
            against = ("against the one-process layer route: "
                       + layer_route_parting(sm, label, ref, ids, want if flips else None))
        print(f"{label} ({MIXTRAL_LABEL} widths cut to {L} layers, W4A8, int8 KV; each rank "
              f"{r0['local_bytes'][name] / 1e9:.3f} GB of local weights, set-up "
              f"{r0['setup_s']:.1f} s for both meshes): prefill logits {share:.4f} of "
              f"check_logits' limit, bit-equal {bit_equal}, routing flips {len(flips)}; first "
              f"step's logits relative L2 {rel:.4g}; ranks' ids equal, {against}; generate "
              f"{1e3 * r0[name]['generate_s']:.2f} ms for the prefill and {MOE_TP_STEPS} eager "
              f"steps; timed warm: the prefill {1e3 * got['prefill_s']:.2f} ms (one process "
              f"{1e3 * ref['prefill_s']:.2f}), {1e3 * got['steps_s'] / MOE_TP_TIMED:.2f} ms a "
              f"step (the one-process loop {1e3 * ref['steps_s'] / MOE_TP_STEPS:.2f}); "
              f"launches a rank: generate {r0[name]['generate_counts']}; collectives a rank "
              f"over generate {r0[name]['collectives']}", flush=True)
        out[name] = r0[name]["generate_counts"]
    del params
    torch.cuda.empty_cache()
    print(f"tp-moe: phase wall {wall:.1f} s for the ranks ({TP_LABEL}; {smi.splitlines()[0]}); "
          "these times are functional numbers, not a tensor- or expert-parallel speed figure",
          flush=True)
    return out


def mh_prompts(torch, cfg) -> list:
    """MultiHostServer's requests: one prompt of each MH_PROMPT_LENS length
    from a generator seeded 2 (token lists)."""
    gen = torch.Generator()
    gen.manual_seed(2)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in MH_PROMPT_LENS]


def multihost_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase multihost, a process of its own: joins the gloo
    group of MH_RANKS, builds `make_hybrid_mesh(dcn_dp=2, tp=2)`, makes the
    seeded 8b-w4a8 tree (`make_8b`) on the card, checks that every rank holds
    the same bytes, builds `MultiHostServer` on it (which shards it) and
    serves `mh_prompts` (rank 0's; the others pass None), then builds
    `MultiHostEngine` (MH_ENGINE) on the same tree, frees the whole tree and
    serves the same requests through the engine. Saves what it saw to
    ``out_dir/rank{rank}.pt``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.engine import Request
    from metalchat_tpu_torch.parallel import (
        MultiHostEngine,
        MultiHostServer,
        initialize,
        make_hybrid_mesh,
        shutdown,
    )

    initialize(f"file://{store}", MH_RANKS, rank, backend=TP_BACKEND,
               timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    try:
        mesh = make_hybrid_mesh(dcn_dp=2, tp=2)
        t0 = time.perf_counter()
        cfg, full = make_8b(Smoke(torch), f"multihost rank {rank}: 8b-w4a8", **W4A8)
        out = same_tree(torch, full)
        server = MultiHostServer(full, cfg, mesh, batch_size=MH_BATCH, max_new_tokens=MH_NEW,
                                 quantized_kv=True)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        out.update(setup_s=time.perf_counter() - t0, local_bytes=weight_bytes(server.params),
                   place={a: mesh.index(a) for a in ("dp", "tp")}, shape=mesh.shape)
        before = dict(mesh.counts)
        reset_launch_counts()
        t = time.perf_counter()
        results = server.serve(mh_prompts(torch, cfg) if rank == 0 else None)
        torch.cuda.synchronize()
        out.update(results=results, counts=launch_counts(), s=time.perf_counter() - t,
                   collectives={k: v - before.get(k, 0) for k, v in mesh.counts.items()})
        del server
        engine = MultiHostEngine(full, cfg, mesh, **MH_ENGINE)
        del full
        torch.cuda.empty_cache()
        requests = None
        if rank == 0:
            requests = [Request(prompt=p, max_new_tokens=MH_NEW) for p in mh_prompts(torch, cfg)]
        before = dict(mesh.counts)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        done = engine.run(requests)
        torch.cuda.synchronize()
        e = engine.engine
        out["engine"] = dict(
            streams=[(c.tokens, c.finished, c.error) for c in done.values()],
            counts=launch_counts(), s=time.perf_counter() - t, counters=dict(e.counters),
            shapes=dict(e.prefill_shapes), route=e.forward_fn.__qualname__.split(".")[0],
            local_slots=int(e.cache.k.shape[1]), captures=len(e._graphs),
            collectives={k: v - before.get(k, 0) for k, v in mesh.counts.items()})
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        shutdown()


def phase_multihost(sm: Smoke, main, smi: str):
    """`MultiHostServer` on `make_hybrid_mesh(dcn_dp=2, tp=2)`, MH_RANKS ranks
    on one card over `TP_BACKEND` (`multihost_rank`), on main's 8b-w4a8 tree
    (every rank's digest must equal it): requests of mixed prompt lengths
    (MH_PROMPT_LENS, two rounds), MH_NEW greedy tokens each on the sharded
    layer route. Rank 0's ids equal, request by request, to a one-process
    loop of `forward(fast_decode=False)` on a cache of the same length (the
    layer route under tp is the single device's function); the other ranks
    return nothing; launches exact per rank (flash a layer a round's
    prefill, row 6 a layer a step). Then `MultiHostEngine` (MH_ENGINE: 2
    slots a dp row, the tensor-parallel decode) on the same requests:
    every rank's streams the same, rank 0's ids equal to the one-process
    engine's or parted at a near tie (`engine_parting`), each rank's cache
    its dp row's 2 slots, launches exact per rank (row 1 and row 3 on every
    step of every burst, flash only for the prompt windows its dp row
    owns)."""
    torch = sm.torch
    import tempfile

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import launch_counts

    cfg, params = main[0], main[1]
    L = cfg.num_layers
    print(f"multihost: {MH_RANKS} ranks over {TP_BACKEND} on one card, make_hybrid_mesh("
          "dcn_dp=2, tp=2); each rank makes the 8b-w4a8 tree on the card and frees it after "
          "MultiHostServer shards it", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_ranks(sm, "multihost", multihost_rank, MH_RANKS, MH_TIMEOUT_S, tmp)
    r0 = ranks[0]
    sm.expect(all(r["same_bytes"] for r in ranks), "multihost: the ranks' trees differ")
    sm.expect(torch.equal(tree_digest(torch, params), r0["digest"]),
              "multihost: the ranks' tree differs from main's 8b-w4a8 params")
    prompts = mh_prompts(torch, cfg)
    want, ref_s = [], 0.0
    for p in prompts:
        prompt = torch.tensor([p], device="cuda")
        cache = QuantizedKVCache.create(cfg, 1, len(p) + MH_NEW, device="cuda")
        ref = tp_greedy(torch, lambda q, c, t, s: forward(q, c, t, s, cfg, fast_decode=False),
                        params, cache, prompt, MH_NEW - 1)
        want.append(ref["ids"].tolist())
        ref_s += ref["prefill_s"] + ref["steps_s"]
    sm.expect(r0["results"] == want, "multihost: rank 0's ids differ from the one-process "
              f"layer route's: {[sum(a == b for a, b in zip(g, w)) for g, w in zip(r0['results'], want)]} "
              "equal of each")
    rounds = len(set(MH_PROMPT_LENS))
    expected = {**dict.fromkeys(launch_counts(), 0), "flash_attention": L * rounds,
                "decode_attention_layer": L * rounds * (MH_NEW - 1)}
    for r, res in enumerate(ranks):
        if r:
            sm.expect(res["results"] == [], f"multihost: rank {r} returned {res['results']}")
        sm.expect(res["counts"] == expected, f"multihost: rank {r} launches {res['counts']} "
                  f"!= {expected}")
        sm.expect(res["place"] == {"dp": r // 2, "tp": r % 2},
                  f"multihost: rank {r} at {res['place']}")
    tokens = len(prompts) * MH_NEW
    print(f"multihost ({MH_RANKS} ranks over {TP_BACKEND} on one card; 8b-w4a8, all {L} layers, "
          f"mesh {r0['shape']}, each rank {r0['local_bytes'] / 1e9:.3f} GB of local weights, "
          f"set-up {r0['setup_s']:.1f} s; {len(prompts)} requests of {list(MH_PROMPT_LENS)} "
          f"prompt tokens in {rounds} rounds of batch {MH_BATCH}, {MH_NEW} greedy tokens each, "
          f"int8 KV): rank 0's ids equal to the one-process layer route's, request by request; "
          f"{tokens / r0['s']:.2f} tok/s over {r0['s']:.2f} s (the one-process layer-route loop "
          f"{ref_s:.2f} s for the same requests one by one); launches a rank {r0['counts']}; "
          f"collectives a rank {r0['collectives']}", flush=True)
    engine = multihost_engine_check(sm, main, ranks, prompts)
    print(f"multihost: phase wall {wall:.1f} s for the ranks ({smi.splitlines()[0]}); "
          "functional numbers, not a parallel speed figure", flush=True)
    return {"server": r0["counts"], "engine": engine}


def engine_parting(sm: Smoke, what: str, params, cfg, prompt, ids, got,
                   fast_decode: bool = True) -> str:
    """``got`` (a request's ids) against the one-process engine's ``ids``:
    identical, or parted first at an index j where the one-process greedy
    route (the prompt's prefill, then one-token steps over ids[:j] on an
    int8 cache; with ``fast_decode=False`` the layer route) has ``ids[j]``
    and ``got[j]`` as its top two logits within `check_logits`' limit of
    each other. Otherwise the phase fails."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    diff = [i for i, (a, b) in enumerate(zip(got, ids)) if a != b]
    if not diff:
        return "identical"
    j, m, dev = diff[0], len(prompt), "cuda"
    cache = QuantizedKVCache.create(cfg, 1, m + j + 1, device=dev)
    row = forward(params, cache, torch.tensor([prompt], device=dev), 0, cfg,
                  fast_decode=fast_decode)[0][0, -1]
    for i in range(j):
        row = forward(params, cache, torch.tensor([[ids[i]]], device=dev), m + i, cfg,
                      fast_decode=fast_decode)[0][0, -1]
    row = row.float()
    top = torch.topk(row, 2)
    gap = (top.values[0] - top.values[1]).item()
    limit = RTOL["bfloat16"] * top.values[0].abs().item() + LOGIT_SHARE * row.abs().max().item()
    sm.expect(sorted(top.indices.tolist()) == sorted([ids[j], got[j]]) and gap <= limit,
              f"{what}: ids part at index {j} (got {got[j]}, one process {ids[j]}; its top two "
              f"{top.indices.tolist()}, gap {gap}, limit {limit}): not a near tie")
    return f"parted at index {j} of {len(ids)}, a near tie (top-2 gap {gap:.4g}, limit {limit:.4g})"


def multihost_engine_check(sm: Smoke, main, ranks, prompts) -> dict:
    """Phase multihost's `MultiHostEngine` run against the one-process
    engine (MH_ENGINE on main's params, its bursts captured); returns rank
    0's launches."""
    torch = sm.torch
    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.ops import launch_counts

    cfg, params = main[0], main[1]
    L = cfg.num_layers
    one = ContinuousBatchingEngine(params, cfg, **MH_ENGINE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = [c.tokens for c in one.run([Request(prompt=p, max_new_tokens=MH_NEW)
                                       for p in prompts]).values()]
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    e0 = ranks[0]["engine"]
    streams = e0["streams"]
    sm.expect(len(streams) == len(prompts) and all(
        f and err is None and len(t) == MH_NEW for t, f, err in streams),
        f"multihost engine: unfinished or short completions "
        f"{[(len(t), f, err) for t, f, err in streams]}")
    partings = [engine_parting(sm, f"multihost engine request {i}", params, cfg, p, w, t)
                for i, (p, w, (t, _, _)) in enumerate(zip(prompts, want, streams))]
    zero = dict.fromkeys(launch_counts(), 0)
    for r, res in enumerate(ranks):
        e = res["engine"]
        sm.expect(e["streams"] == streams, f"multihost engine: rank {r}'s streams differ")
        sm.expect(e["route"] == "tp_decode_forward_fn" and e["captures"] == 0,
                  f"multihost engine: rank {r} route {e['route']}, captures {e['captures']}")
        sm.expect(e["local_slots"] == MH_ENGINE["max_slots"] // 2,
                  f"multihost engine: rank {r} holds {e['local_slots']} slots")
        steps = e["counters"]["decode_steps"]
        windows = sum(n for (b, s_), n in e["shapes"].items() if s_ > 16)
        expect = {**zero, **tp_launches(cfg, steps, windows, "decode_attention_update")}
        sm.expect(e["counts"] == expect,
                  f"multihost engine: rank {r} launches {e['counts']} != {expect}")
    owners = {r: dict(res["engine"]["shapes"]) for r, res in enumerate(ranks)}
    rows = [sum(b * n for (b, _), n in owners[r].items()) for r in range(0, len(ranks), 2)]
    sm.expect(all(owners[r] == owners[r + 1] for r in range(0, len(ranks), 2))
              and sum(rows) == sum(b * n for (b, _), n in one.prefill_shapes.items()),
              f"multihost engine: prompt rows by rank {owners}, one process "
              f"{dict(one.prefill_shapes)}: a prompt ran off its dp row or twice")
    tokens = len(prompts) * MH_NEW
    print(f"multihost engine (MultiHostEngine on the same mesh and tree, {MH_ENGINE}; "
          f"the tensor-parallel decode, every burst eager): streams equal on every rank; "
          f"rank 0 against the one-process engine: {partings}; {tokens / e0['s']:.2f} tok/s "
          f"over {e0['s']:.2f} s (the one-process engine {one_s:.2f} s, its bursts "
          f"captured); counters {e0['counters']}; prompt windows by rank (each its dp row's "
          f"own) {owners}; launches a rank {e0['counts']}; collectives a rank "
          f"{e0['collectives']}", flush=True)
    del one
    torch.cuda.empty_cache()
    return e0["counts"]


# -- the sharded layer route on every leaf kind: phase tp-leaves -----------------

# Three trees that the tensor-parallel decode refuses, through the forward the
# engine picks for them on make_mesh(tp=2) (`spmd_forward_fn`: the sharded
# layer route), two ranks on the card: a prompt, then greedy tokens, on an
# int8 cache of LEAVES_CACHE positions (row 6 at one token).
LEAVES_RANKS, LEAVES_PROMPT, LEAVES_NEW, LEAVES_CACHE = 2, 128, 8, 256
LEAVES_TIMEOUT_S = 420
LEAVES_TREES = ("8b-int4", QLORA_LABEL, "gpt2-large-w8a8")
# openai-community/gpt2-large's config.json: 36 layers of 20 heads of 64,
# hidden 1280, intermediate 5120, 1024 positions, vocabulary 50257 (odd: the
# embedding and the tied head stay whole on each rank).
GPT2_LARGE_JSON = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "n_embd": 1280,
                   "n_head": 20, "n_layer": 36, "n_positions": 1024, "n_ctx": 1024,
                   "vocab_size": 50257, "layer_norm_epsilon": 1e-5,
                   "activation_function": "gelu_new", "bos_token_id": 50256,
                   "eos_token_id": 50256}


def leaves_tree(torch, name: str, tmp: str):
    """(config, whole tree on the card, weight-only linears a window) of
    phase tp-leaves' tree ``name``: 8b-int4 as `make_8b` builds it (group
    32, wqkv and w13 fused), qlora-1b from the reference-dialect file the
    phase wrote to ``tmp`` (int8 group 32, f32 scales, rank-16 adaptors on
    every projection, the head tied), GPT-2 large W8A8 with non-zero biases
    and wqkv fused (`make_gpt2_params`)."""
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.quant.checkpoint import load_reference_qlora

    if name == "8b-int4":
        cfg, params = make_8b(Smoke(torch), "tp-leaves 8b-int4", bits=4, group_size=32)
        return cfg, params, 4 * cfg.num_layers + 1
    if name == QLORA_LABEL:
        cfg = config_from_dict(LLAMA32_1B_CONFIG).replace(max_seq_len=1024)
        params = load_reference_qlora(open_safetensors(f"{tmp}/qlora.safetensors"), cfg,
                                      device="cuda", max_seq_len=1024)
        return cfg, params, 7 * cfg.num_layers + 1
    cfg = config_from_dict(GPT2_LARGE_JSON)
    return cfg, make_gpt2_params(cfg, "cuda"), 0


def leaves_prompt(torch, cfg):
    """A prompt of LEAVES_PROMPT tokens from a generator seeded 0 on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (1, LEAVES_PROMPT), generator=gen, device="cuda")


def leaves_launches(cfg, weight_only: int, steps: int, prefills: int) -> dict:
    """The sharded layer route's launches: flash a layer a prompt window, row
    6 a layer a one-token step, row 11 once a weight-only linear a step (a
    prompt's 128 rows take the plain product), nothing else."""
    from metalchat_tpu_torch.ops import launch_counts

    L = cfg.num_layers
    want = {**dict.fromkeys(launch_counts(), 0), "flash_attention": L * prefills,
            "decode_attention_layer": L * steps}
    want["quant_matmul"] = weight_only * steps
    return want


def leaves_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase tp-leaves, a process of its own: for each of
    LEAVES_TREES it makes the tree on the card (`leaves_tree`), checks that
    every rank holds the same bytes, shards it for tp 2 (`shard_params`),
    frees the whole tree and runs `tp_greedy` through `spmd_forward_fn`'s
    forward. Saves what it saw to ``out_dir/rank{rank}.pt``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.parallel import (
        initialize,
        make_mesh,
        shard_cache,
        shard_params,
        shutdown,
        spmd_forward_fn,
    )

    initialize(f"file://{store}", LEAVES_RANKS, rank, backend=TP_BACKEND,
               timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    try:
        mesh = make_mesh(tp=LEAVES_RANKS)
        out = {}
        for name in LEAVES_TREES:
            t0 = time.perf_counter()
            cfg, full, _ = leaves_tree(torch, name, out_dir)
            res = same_tree(torch, full)
            params = shard_params(full, cfg, mesh)
            del full
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            res.update(setup_s=time.perf_counter() - t0, local_bytes=weight_bytes(params))
            fwd = spmd_forward_fn(params, cfg, mesh)
            cache = shard_cache(QuantizedKVCache.create(cfg, 1, LEAVES_CACHE, device="cuda"),
                                mesh)
            before = dict(mesh.counts)
            res["greedy"] = tp_greedy(torch, fwd, params, cache, leaves_prompt(torch, cfg),
                                      LEAVES_NEW - 1)
            res.update(route=fwd.__qualname__.split(".")[0],
                       collectives={k: v - before.get(k, 0) for k, v in mesh.counts.items()})
            out[name] = res
            del params, cache
            torch.cuda.empty_cache()
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        shutdown()


def phase_tp_leaves(sm: Smoke, int4_run, smi: str):
    """The sharded layer route on the leaf kinds the tensor-parallel decode
    refuses, `LEAVES_RANKS` ranks on one card over `TP_BACKEND`
    (`leaves_rank`): 8b-int4 at Llama-3.1-8B's width and depth (group-wise
    int4, fused: row 11 at the tp-local shapes, the row-parallel ones in its
    f32 mode), qlora-1b at Llama-3.2-1B's (int8 group 32 bases with LoRA
    adaptors, all 16 layers) and GPT-2 large's published widths (W8A8, non-
    zero biases, wqkv fused, an odd vocabulary). Each: a 128-token prompt
    and 8 greedy tokens on an int8 cache, held against one process's
    `forward(fast_decode=False)` on the same tree (every rank's digest equal
    to it; 8b-int4's tree is phase main-int4's): the prefill's last logits
    within `check_logits`' limit, the ids equal or parted at a near tie
    (`layer_route_parting`), every rank's ids the same, the route the
    sharded layer route, launches exact per rank (`leaves_launches`)."""
    torch = sm.torch
    import tempfile
    from pathlib import Path

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.models.transformer import forward

    print(f"tp-leaves: {LEAVES_RANKS} ranks over {TP_BACKEND} on one card, make_mesh(tp="
          f"{LEAVES_RANKS}); each rank makes {', '.join(LEAVES_TREES)} in turn on the card, "
          "shards it and frees the whole tree", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        nbytes = write_reference_qlora(Path(tmp) / "qlora.safetensors",
                                       config_from_dict(LLAMA32_1B_CONFIG))
        print(f"tp-leaves: {QLORA_LABEL}'s reference file, {nbytes / 1e9:.4f} GB, written in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        ranks, wall = spawn_ranks(sm, "tp-leaves", leaves_rank, LEAVES_RANKS, LEAVES_TIMEOUT_S,
                                  tmp)
        for name in LEAVES_TREES:
            if name == "8b-int4" and int4_run is not None:
                cfg, params, n_wo = int4_run[0], int4_run[1], 4 * int4_run[0].num_layers + 1
            else:
                cfg, params, n_wo = leaves_tree(torch, name, tmp)
            label = f"tp-leaves {name}"
            r0 = ranks[0][name]
            sm.expect(all(r[name]["same_bytes"] for r in ranks),
                      f"{label}: the ranks' trees differ")
            sm.expect(torch.equal(tree_digest(torch, params), r0["digest"]),
                      f"{label}: the ranks' tree differs from this process's")
            ref = tp_greedy(torch, lambda p, c, t_, s_: forward(p, c, t_, s_, cfg,
                                                                 fast_decode=False),
                            params, QuantizedKVCache.create(cfg, 1, LEAVES_CACHE, device="cuda"),
                            leaves_prompt(torch, cfg), LEAVES_NEW - 1)
            got = r0["greedy"]
            share = check_logits(sm, f"{label} prefill's last logits", got["prefill"][-1:],
                                 ref["prefill"][-1:])
            parting = layer_route_parting(sm, label, ref, got["ids"])
            for r, res in enumerate(ranks):
                g = res[name]["greedy"]
                sm.exact(g["ids"], got["ids"], f"{label}: rank {r}'s ids against rank 0's")
                sm.expect(res[name]["route"] == "layer_route_forward_fn",
                          f"{label}: rank {r} took {res[name]['route']}")
                for what, counts, want in (
                        ("prefill", g["prefill_counts"], leaves_launches(cfg, n_wo, 0, 1)),
                        ("steps", g["step_counts"],
                         leaves_launches(cfg, n_wo, LEAVES_NEW - 1, 0))):
                    sm.expect(counts == want, f"{label}: rank {r}'s {what} launches {counts} "
                              f"!= {want}")
            print(f"{label} ({TP_LABEL}; all {cfg.num_layers} layers, each rank "
                  f"{r0['local_bytes'] / 1e9:.3f} GB of local weights, set-up "
                  f"{r0['setup_s']:.1f} s): prefill's last logits {share:.4f} of check_logits' "
                  f"limit (bit-equal {bool(torch.equal(got['prefill'][-1], ref['prefill'][-1]))}); "
                  f"ranks' ids equal, against one process's forward(fast_decode=False): "
                  f"{parting}; the prefill {1e3 * got['prefill_s']:.2f} ms (one process "
                  f"{1e3 * ref['prefill_s']:.2f}), {1e3 * got['steps_s'] / (LEAVES_NEW - 1):.2f} "
                  f"ms a step (one process {1e3 * ref['steps_s'] / (LEAVES_NEW - 1):.2f}); "
                  f"launches a rank: prefill {got['prefill_counts']}, steps "
                  f"{got['step_counts']}; collectives a rank {r0['collectives']}", flush=True)
            out[name] = got["step_counts"]
            if name != "8b-int4":
                del params
            torch.cuda.empty_cache()
    print(f"tp-leaves: phase wall {wall:.1f} s for the ranks ({TP_LABEL}; {smi.splitlines()[0]}); "
          "functional numbers, not a tensor-parallel speed figure", flush=True)
    return out


# phase train-tp (a): the sharded train step on dp 2 × tp 2 (4 ranks on the
# card over gloo), qlora-1b's tree cut to its first TRAIN_TP_LAYERS layers,
# TRAIN_TP_STEPS Adam steps (TRAIN_LR, remat) on TRAIN_TP_BATCH against one
# process's steps on the same cut; (b) Gemma-3-1B W8A8 at tp 2 through
# `spmd_forward_fn` (its one kv-head whole on both ranks: the sharded layer
# route) on ranks 0 and 1, at tp-leaves' prompt, tokens and cache.
TRAIN_TP_DP, TRAIN_TP_TP = 2, 2
TRAIN_TP_RANKS = TRAIN_TP_DP * TRAIN_TP_TP
TRAIN_TP_LAYERS = 4
TRAIN_TP_BATCH = (4, 128)
TRAIN_TP_STEPS = 3
TRAIN_TP_SEED = 23
# grad_norm of the sharded step against one process's: both bf16, the same
# function; the sums in another order move it by bf16 roundings (2^-9) of
# the gradients, which the norm averages over millions of elements.
TRAIN_TP_NORM_RTOL = 1e-3
TRAIN_TP_TIMEOUT_S = 420


def train_tp_config():
    """qlora-1b's config cut to TRAIN_TP_LAYERS layers."""
    from metalchat_tpu_torch.config import config_from_dict

    return config_from_dict(LLAMA32_1B_CONFIG).replace(max_seq_len=1024,
                                                       num_layers=TRAIN_TP_LAYERS)


def train_tp_batch(torch, cfg, device):
    """TRAIN_TP_BATCH's global batch, drawn on the CPU from TRAIN_TP_SEED (the
    same on every rank), on ``device``."""
    rows, s = TRAIN_TP_BATCH
    gen = torch.Generator().manual_seed(TRAIN_TP_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (rows, s + 1), generator=gen)
    return {"tokens": tokens.to(device), "loss_mask": torch.ones(rows, s, device=device)}


def train_tp_steps(torch, cfg, params, batch, mesh=None, full=False, aux=0.0, keep=False,
                   steps=TRAIN_TP_STEPS):
    """``steps`` Adam steps on ``params`` (a rank's local tree with
    ``mesh``), QLoRA's (`trainable_lora`) or with ``full`` every float leaf
    (`trainable_full`), ``aux`` the loss's ``moe_aux_weight``: each step's
    loss, grad_norm and wall ms, the first step's gradients (gathered whole
    on a mesh, f32 on the CPU), the launches during the steps, whether the
    frozen bytes stayed, the state and the partition spec; with ``keep``
    the trained leaves before each step after the first (whole, on the
    CPU) under "leaves"."""
    from metalchat_tpu_torch import train as tt
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.parallel import gather_leaf

    trainable, frozen, spec = tt.partition(params, tt.trainable_full if full
                                           else tt.trainable_lora)
    before = tree_digest(torch, {str(i): t for i, t in enumerate(frozen)})
    loss_fn = functools.partial(tt.causal_lm_loss, moe_aux_weight=aux) if aux else None
    init, step = tt.make_train_step(cfg, lambda ps: torch.optim.Adam(ps, lr=TRAIN_LR), spec,
                                    remat=True, mesh=mesh, loss_fn=loss_fn)
    state = init(trainable)
    sync(torch, "cuda")
    reset_launch_counts()
    losses, norms, ms, grads, kept = [], [], [], None, []
    paths = [None] * len(trainable) if mesh is None else state.layout.paths

    def whole(t, path):
        return t if mesh is None else gather_leaf(t, path, cfg, mesh)

    for i in range(steps):
        if keep and i:
            kept.append([whole(t.detach(), p).to("cpu", copy=True)
                         for t, p in zip(state.trainable, paths)])
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(1e3 * (time.perf_counter() - t0))
        if grads is None:
            grads = [whole(t.grad, p).float().cpu() for t, p in zip(state.trainable, paths)]
    counts = launch_counts()
    same = torch.equal(before, tree_digest(torch, {str(i): t for i, t in enumerate(frozen)}))
    return {"losses": losses, "norms": norms, "ms": ms, "grads": grads, "counts": counts,
            "frozen_same": same, "state": state, "spec": spec, "frozen": frozen,
            "leaves": kept}


def train_tp_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase train-tp, a process of its own: (a) the 4-layer
    qlora cut from the reference file the parent wrote, sharded for
    `make_mesh(tp=2, dp=2)`, `train_tp_steps` on it, then the state gathered
    (`gather_train_state`); (b) on ranks 0 and 1 (a tp-2 mesh on their
    pair), Gemma-3-1B W8A8 made on the card (`make_gemma`), sharded, and
    `tp_greedy` through `spmd_forward_fn`'s forward. Saves what it saw to
    ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    from metalchat_tpu_torch import train as tt
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.parallel import (
        initialize,
        make_mesh,
        shard_cache,
        shard_params,
        shutdown,
        spmd_forward_fn,
    )
    from metalchat_tpu_torch.quant.checkpoint import load_reference_qlora

    initialize(f"file://{store}", TRAIN_TP_RANKS, rank, backend=TP_BACKEND,
               timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    try:
        mesh = make_mesh(tp=TRAIN_TP_TP, dp=TRAIN_TP_DP)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        t0 = time.perf_counter()
        cfg = train_tp_config()
        params = shard_params(load_reference_qlora(open_safetensors(f"{out_dir}/qlora.safetensors"),
                                                   cfg, device="cuda", max_seq_len=1024),
                              cfg, mesh)
        res = {"setup_s": time.perf_counter() - t0}
        before = dict(mesh.counts)
        run = train_tp_steps(torch, cfg, params, train_tp_batch(torch, cfg, "cuda"), mesh)
        res["collectives"] = {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                              if v != before.get(k, 0)}
        t0 = time.perf_counter()
        whole = tt.gather_train_state(run.pop("state"))
        res["gather_s"] = time.perf_counter() - t0
        res.update({k: v for k, v in run.items() if k not in ("spec", "frozen")},
                   trained=[t.detach().cpu() for t in whole.trainable] if rank == 0 else None)
        del params, run, whole
        torch.cuda.empty_cache()
        if rank < 2:
            t0 = time.perf_counter()
            pair = make_mesh(tp=2, group=pairs[0])
            gcfg, full = make_gemma(Smoke(torch), "cuda")
            digest = tree_digest(torch, full)
            local = shard_params(full, gcfg, pair)
            del full
            torch.cuda.empty_cache()
            fwd = spmd_forward_fn(local, gcfg, pair)
            cache = shard_cache(QuantizedKVCache.create(gcfg, 1, LEAVES_CACHE, device="cuda"),
                                pair)
            setup = time.perf_counter() - t0
            before = dict(pair.counts)
            greedy = tp_greedy(torch, fwd, local, cache, leaves_prompt(torch, gcfg),
                               LEAVES_NEW - 1)
            res["gemma"] = dict(greedy=greedy, digest=digest, setup_s=setup,
                                route=fwd.__qualname__.split(".")[0],
                                cache_heads=int(cache.k.shape[2]),
                                collectives={k: v - before.get(k, 0)
                                             for k, v in pair.counts.items()
                                             if v != before.get(k, 0)})
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        shutdown()


def phase_train_tp(sm: Smoke, gemma_run, smi: str):
    """train-tp, `TRAIN_TP_RANKS` ranks on one card over `TP_BACKEND`
    (`train_tp_rank`). (a) The sharded QLoRA step at Llama-3.2-1B's widths
    (qlora-1b's tree: int8 g32 bases, rank-16 adaptors, the head tied; cut
    to TRAIN_TP_LAYERS layers) on dp 2 × tp 2, against one process's steps
    on the same cut and batch: each loss within TRAIN_LOSS_RTOL, each first-
    step adaptor gradient within TRAIN_GRAD_RTOL (relative L2), grad_norm
    within TRAIN_TP_NORM_RTOL, no kernel launched, the frozen bytes
    unchanged, every rank's metrics equal; the gathered tree's greedy ids
    (`tp_greedy` on the layer route) equal to the one process's tuned
    tree's, or parted at a near tie (`layer_route_parting`). (b) Gemma-3-1B
    W8A8 at full width and depth at tp 2 (phase gemma's tree, every rank's
    digest equal to it): its one kv-head whole on each rank, 2 query heads a
    rank; a 128-token prompt and 8 greedy tokens against one process's
    `forward(fast_decode=False)`: the prefill's last logits within
    `check_logits`' limit, the ids equal or parted at a near tie, the route
    the sharded layer route, launches exact a rank (rows 4 and 6 at 2 query
    heads over 1 kv-head, hd 256). Returns (b)'s launches."""
    torch = sm.torch
    import tempfile
    from pathlib import Path

    from metalchat_tpu_torch import train as tt
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.quant.checkpoint import load_reference_qlora

    label = f"train-tp ({TRAIN_TP_RANKS} ranks over {TP_BACKEND} on one card)"
    print(f"{label}: (a) {QLORA_LABEL} cut to {TRAIN_TP_LAYERS} layers, make_mesh(tp="
          f"{TRAIN_TP_TP}, dp={TRAIN_TP_DP}), {TRAIN_TP_STEPS} Adam steps on "
          f"{TRAIN_TP_BATCH[0]} x {TRAIN_TP_BATCH[1]} inputs; (b) {GEMMA_LABEL} at tp 2 on "
          "ranks 0 and 1", flush=True)

    def one_layer_route(p, c, t_, s_, cfg):
        return forward(p, c, t_, s_, cfg, fast_decode=False)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_tp_config()
        write_reference_qlora(Path(tmp) / "qlora.safetensors", cfg)
        ranks, wall = spawn_ranks(sm, "train-tp", train_tp_rank, TRAIN_TP_RANKS,
                                  TRAIN_TP_TIMEOUT_S, tmp)
        t0 = time.perf_counter()
        params = load_reference_qlora(open_safetensors(Path(tmp) / "qlora.safetensors"), cfg,
                                      device="cuda", max_seq_len=1024)
    one = train_tp_steps(torch, cfg, params, train_tp_batch(torch, cfg, "cuda"))
    one_s = time.perf_counter() - t0
    r0 = ranks[0]
    what = f"train-tp (a) {QLORA_LABEL} {TRAIN_TP_LAYERS} layers"
    for r, res in enumerate(ranks):
        sm.expect((res["losses"], res["norms"]) == (r0["losses"], r0["norms"]),
                  f"{what}: rank {r}'s metrics {res['losses']} {res['norms']} against rank "
                  f"0's {r0['losses']} {r0['norms']}")
        sm.expect(not any(res["counts"].values()), f"{what}: rank {r} launched "
                  f"{res['counts']}")
        sm.expect(res["frozen_same"], f"{what}: a frozen leaf changed on rank {r}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"])]
    norm_rel = abs(r0["norms"][0] - one["norms"][0]) / one["norms"][0]
    grad_rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(r0["grads"], one["grads"])]
    sm.expect(max(loss_rel) <= TRAIN_LOSS_RTOL, f"{what}: losses {r0['losses']} against one "
              f"process's {one['losses']}")
    sm.expect(norm_rel <= TRAIN_TP_NORM_RTOL, f"{what}: grad_norm {r0['norms'][0]} against "
              f"{one['norms'][0]}")
    sm.expect(len(grad_rel) == len(one["grads"]) and max(grad_rel) <= TRAIN_GRAD_RTOL,
              f"{what}: first-step adaptor gradients against one process's {grad_rel}")
    sm.expect(not any(one["counts"].values()), f"{what}: one process launched {one['counts']}")
    frozen, spec = one["frozen"], one["spec"]
    tuned = tt.combine([t.detach() for t in one["state"].trainable], frozen, spec)
    gathered = tt.combine([t.to("cuda") for t in r0["trained"]], frozen, spec)
    prompt = leaves_prompt(torch, cfg)
    ref = tp_greedy(torch, functools.partial(one_layer_route, cfg=cfg), tuned,
                    QuantizedKVCache.create(cfg, 1, LEAVES_CACHE, device="cuda"), prompt,
                    LEAVES_NEW - 1)
    got = tp_greedy(torch, functools.partial(one_layer_route, cfg=cfg), gathered,
                    QuantizedKVCache.create(cfg, 1, LEAVES_CACHE, device="cuda"), prompt,
                    LEAVES_NEW - 1)
    parting = layer_route_parting(sm, f"{what}: the gathered tree", ref, got["ids"])
    print(f"{what}: losses {r0['losses']} (one process {one['losses']}, max "
          f"{max(loss_rel):.3g} apart, limit {TRAIN_LOSS_RTOL}); grad_norm {r0['norms'][0]:.6f} "
          f"(one process {one['norms'][0]:.6f}, {norm_rel:.3g} apart, limit "
          f"{TRAIN_TP_NORM_RTOL}); {len(grad_rel)} first-step adaptor gradients, relative L2 "
          f"max {max(grad_rel):.4g} (limit {TRAIN_GRAD_RTOL}); metrics equal on all "
          f"{TRAIN_TP_RANKS} ranks, no launch, frozen bytes unchanged; the gathered tree's "
          f"{LEAVES_NEW} greedy ids against the one process's tuned tree: {parting}", flush=True)
    print(f"{what}: rank 0 set-up {r0['setup_s']:.2f} s, step wall ms "
          f"{[round(x, 1) for x in r0['ms']]} (one process "
          f"{[round(x, 1) for x in one['ms']]}), gather {r0['gather_s']:.2f} s; "
          f"collectives a rank over the {TRAIN_TP_STEPS} steps and the first step's "
          f"gradient gather {r0['collectives']}; one "
          f"process {one_s:.2f} s; gloo moves CUDA tensors through the host, so these are "
          "functional numbers, not a parallel speed figure", flush=True)
    del one, tuned, gathered, params, frozen
    torch.cuda.empty_cache()

    gcfg, gparams = gemma_run[0], gemma_run[1]
    what = f"train-tp (b) {GEMMA_LABEL} tp 2"
    g0 = ranks[0]["gemma"]
    sm.expect(torch.equal(tree_digest(torch, gparams), g0["digest"]) and
              torch.equal(ranks[1]["gemma"]["digest"], g0["digest"]),
              f"{what}: the ranks' tree differs from phase gemma's")
    ref = tp_greedy(torch, functools.partial(one_layer_route, cfg=gcfg), gparams,
                    QuantizedKVCache.create(gcfg, 1, LEAVES_CACHE, device="cuda"),
                    leaves_prompt(torch, gcfg), LEAVES_NEW - 1)
    got = g0["greedy"]
    share = check_logits(sm, f"{what} prefill's last logits", got["prefill"][-1:],
                         ref["prefill"][-1:])
    parting = layer_route_parting(sm, what, ref, got["ids"])
    want_prefill = leaves_launches(gcfg, 0, 0, 1)
    want_steps = leaves_launches(gcfg, 0, LEAVES_NEW - 1, 0)
    for r in (0, 1):
        g = ranks[r]["gemma"]
        sm.exact(g["greedy"]["ids"], got["ids"], f"{what}: rank {r}'s ids against rank 0's")
        sm.expect(g["route"] == "layer_route_forward_fn" and g["cache_heads"] == 1,
                  f"{what}: rank {r} took {g['route']} over {g['cache_heads']} kv-heads")
        for part, counts, want in (("prefill", g["greedy"]["prefill_counts"], want_prefill),
                                   ("steps", g["greedy"]["step_counts"], want_steps)):
            sm.expect(counts == want, f"{what}: rank {r}'s {part} launches {counts} != {want}")
    print(f"{what} (all {gcfg.num_layers} layers, 2 query heads over the one kv-head a rank, "
          f"set-up {g0['setup_s']:.1f} s): prefill's last logits {share:.4f} of check_logits' "
          f"limit (bit-equal {bool(torch.equal(got['prefill'][-1], ref['prefill'][-1]))}); "
          f"ranks' ids equal, against one process's forward(fast_decode=False): "
          f"{parting}; the prefill {1e3 * got['prefill_s']:.2f} ms (one process "
          f"{1e3 * ref['prefill_s']:.2f}), {1e3 * got['steps_s'] / (LEAVES_NEW - 1):.2f} ms a "
          f"step (one process {1e3 * ref['steps_s'] / (LEAVES_NEW - 1):.2f}); launches a rank: "
          f"prefill {({k: v for k, v in got['prefill_counts'].items() if v})}, steps "
          f"{({k: v for k, v in got['step_counts'].items() if v})}; collectives a rank "
          f"{g0['collectives']}", flush=True)
    print(f"train-tp: ranks' wall {wall:.1f} s ({smi.splitlines()[0]}); functional numbers, "
          "not a parallel speed figure", flush=True)
    return {"prefill": got["prefill_counts"], "steps": got["step_counts"]}


# phase train-moe: the sharded train step on an MoE tree, dp 2 × ep 2 (4
# ranks on the card over gloo): Mixtral-8x7B's widths cut to
# TRAIN_MOE_LAYERS layers (`make_train_moe`: random bf16 weights quantized
# as the JAX package trains an MoE on a mesh, int8 in groups of 32, every
# linear, the experts included), `trainable_full` (router, norms, embedding,
# head), TRAIN_TP_STEPS Adam steps (TRAIN_LR, remat, moe_aux_weight
# TRAIN_MOE_AUX) on TRAIN_TP_BATCH, each step held to one process's step on
# the leaves the ranks held before it, within train-tp (a)'s limits. Two
# free-running bf16 trajectories part by step 3 here (the loss falls from
# 11.2 to 1.1 in three steps: 2.6% apart on an H100, with the first loss
# bit-equal and the first gradients 0.14-0.9% apart), so the free run is
# printed, not held.
TRAIN_MOE_DP, TRAIN_MOE_EP = 2, 2
TRAIN_MOE_RANKS = TRAIN_MOE_DP * TRAIN_MOE_EP
TRAIN_MOE_LAYERS = 2
TRAIN_MOE_AUX = 0.01
TRAIN_MOE_SEED = 24
TRAIN_MOE_TIMEOUT_S = 420
TRAIN_MOE_LABEL = f"mixtral-8x7b int8 g32, {TRAIN_MOE_LAYERS} layers"
# the first-step gradients held to one process's (the issue's list): the
# router, the norms and the head
TRAIN_MOE_HELD = ("router", "norm", "lm_head")


def quantize_on_card(torch, w, group_size: int = 32):
    """`quant.quantize.quantize(w, bits=8, group_size=group_size)` of a dense
    ``[..., in, out]`` weight on its own device, in `quantize_params`'
    storage (`auto_orient`: transposed where out > in; f32 scales): each
    group of ``group_size`` input rows' absmax over 127, codes ``w · (1 /
    scale)`` rounded half to even and clipped to ±127, the same f32 steps as
    that function's numpy ones (`make_train_moe` holds the bytes equal)."""
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor

    in_f, out_f = w.shape[-2:]
    g = w.float().reshape(*w.shape[:-2], in_f // group_size, group_size, out_f)
    # true divisions by tensors: on the card PyTorch divides by a Python
    # scalar as a product with its reciprocal, a last-ulp apart
    scales = g.abs().amax(dim=-2, keepdim=True) / torch.tensor(127.0, device=g.device)
    inv = torch.where(scales == 0.0, torch.zeros_like(scales),
                      torch.ones_like(scales) / scales)
    q = (g * inv).round().clamp(-127.0, 127.0).to(torch.int8).reshape(w.shape)
    sc = scales.squeeze(-2)
    transposed = out_f > in_f
    if transposed:
        q, sc = q.transpose(-1, -2).contiguous(), sc.transpose(-1, -2).contiguous()
    return QuantizedTensor(q=q, scales=sc, bits=8, group_size=group_size,
                           transposed=transposed, act_bits=None)


def make_train_moe(torch, device, check: bool = False):
    """(config, tree): `MixtralConfig.mixtral_8x7b` cut to TRAIN_MOE_LAYERS
    layers (context 1024) with random bf16 weights, N(0, 0.02) from
    TRAIN_MOE_SEED (`init_random_params`' draw for everything but the
    experts; each expert matrix from a generator of its own, layer by layer,
    so the f32 draw of one stack never sits whole on the card), every
    linear quantized int8 in groups of 32 by `quantize_on_card`; the router,
    norms, embedding and head dense bf16. With ``check`` the codes, scales
    and orientation of a slice of layer 0's first expert of each stack are
    held to `quantize_params`' (the port's numpy quantizer) byte for
    byte."""
    from metalchat_tpu_torch.config import MixtralConfig
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor, quantize_params

    cfg = MixtralConfig.mixtral_8x7b().replace(max_seq_len=1024, num_layers=TRAIN_MOE_LAYERS)
    L, E, H, F = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    params = init_random_params(cfg.replace(num_experts=0), seed=TRAIN_MOE_SEED,
                                dtype=torch.bfloat16, device=device)
    layers = params["layers"]
    for name in ("wq", "wk", "wv", "wo"):
        layers[name] = quantize_on_card(torch, layers[name])
    for name in EXPERT_LEAVES:  # the dense FFN's leaves
        del layers[name]
    gen = torch.Generator(device=device)
    gen.manual_seed(TRAIN_MOE_SEED + 1)
    layers["router"] = (torch.randn((L, H, E), generator=gen, device=device) * 0.02).to(
        torch.bfloat16)
    dense = {}
    for name, (in_f, out_f) in zip(EXPERT_LEAVES, ((H, F), (H, F), (F, H))):
        parts = []
        for l in range(L):
            for e in range(E):
                w = (torch.randn((in_f, out_f), generator=gen, device=device) * 0.02).to(
                    torch.bfloat16)
                if check and l == e == 0:  # a slice stored as the whole leaf is
                    dense[name] = w[:256] if in_f < out_f else w[:, :256]
                parts.append(quantize_on_card(torch, w))
        q = torch.stack([p.q for p in parts]).reshape(L, E, *parts[0].q.shape)
        sc = torch.stack([p.scales for p in parts]).reshape(L, E, *parts[0].scales.shape)
        layers[name] = QuantizedTensor(q=q, scales=sc, bits=8, group_size=32,
                                       transposed=parts[0].transposed, act_bits=None)
        del parts
    if check:  # the port's quantize_params on the CPU against the card's codes
        for name, w in dense.items():
            want = quantize_params({"layers": {name: w.cpu()}}, bits=8,
                                   group_size=32)["layers"][name]
            got = quantize_on_card(torch, w)
            if not (torch.equal(got.q.cpu(), want.q) and torch.equal(got.scales.cpu(), want.scales)
                    and got.transposed == want.transposed):
                raise AssertionError(f"make_train_moe: {name}'s codes differ from quantize_params'")
    return cfg, params


@contextlib.contextmanager
def recorded_drops(drops: list):
    """Inside the block, every dispatch (`models.moe.dispatch_slots`) appends
    to ``drops`` the count of (token, choice) pairs it dropped (on this
    rank's rows)."""
    from metalchat_tpu_torch.models import moe

    plain = moe.dispatch_slots

    def counted(*args, **kw):
        slot, kept = plain(*args, **kw)
        drops.append(int((~kept).sum()))
        return slot, kept

    moe.dispatch_slots = counted
    try:
        yield drops
    finally:
        moe.dispatch_slots = plain


def train_moe_run(torch, cfg, params, mesh=None, keep=False, leaves=None):
    """`train_tp_steps` with every float leaf trained and the load-balancing
    loss, the dispatch's dropped pairs a layer of the first step's forward,
    the memory held before the steps and their peak above it (GB) beside
    its result; ``keep`` its.
    With ``leaves`` (the trained leaves in partition order) one step from
    them in place of the tree's own."""
    sync(torch, "cuda")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    if leaves is not None:
        from metalchat_tpu_torch import train as tt

        _, frozen, spec = tt.partition(params, tt.trainable_full)
        params = tt.combine([t.to(frozen[0].device) for t in leaves], frozen, spec)
    drops = []
    with recorded_drops(drops):
        run = train_tp_steps(torch, cfg, params, train_tp_batch(torch, cfg, "cuda"), mesh,
                             full=True, aux=TRAIN_MOE_AUX, keep=keep,
                             steps=TRAIN_TP_STEPS if leaves is None else 1)
    sync(torch, "cuda")
    run.update(drops=drops[:cfg.num_layers], held_gb=held / 1e9,
               peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9)
    return run


def train_moe_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase train-moe, a process of its own: `make_train_moe` on
    the card (every rank draws the same tree), `shard_params` for
    `make_mesh(dp=2, ep=2)` (the rank's 4 experts), `train_moe_run` on it.
    Saves what it saw to ``out_dir/rank{rank}.pt``: rank 0 also its first
    step's gradients and the leaves before each later step."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    from metalchat_tpu_torch.parallel import initialize, make_mesh, shard_params, shutdown

    initialize(f"file://{store}", TRAIN_MOE_RANKS, rank, backend=TP_BACKEND,
               timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    try:
        mesh = make_mesh(dp=TRAIN_MOE_DP, ep=TRAIN_MOE_EP)
        t0 = time.perf_counter()
        cfg, full = make_train_moe(torch, "cuda")
        digest = tree_digest(torch, full)
        params = shard_params(full, cfg, mesh)
        del full
        torch.cuda.empty_cache()
        res = {"setup_s": time.perf_counter() - t0, "digest": digest,
               "local_experts": int(params["layers"]["w1"].q.shape[1])}
        before = dict(mesh.counts)
        run = train_moe_run(torch, cfg, params, mesh, keep=rank == 0)
        res["collectives"] = {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                              if v != before.get(k, 0)}
        drop = ("spec", "frozen", "state") + (("grads", "leaves") if rank else ())
        res.update({k: v for k, v in run.items() if k not in drop},
                   paths=["".join(map(str, p)) for p in run["state"].layout.paths])
        torch.save(res, f"{out_dir}/rank{rank}.pt")  # rank 0's gradients and leaves
    finally:
        shutdown()


def phase_train_moe(sm: Smoke, smi: str):
    """train-moe, `TRAIN_MOE_RANKS` ranks on one card over `TP_BACKEND`
    (`train_moe_rank`): the sharded step of an MoE tree at Mixtral-8x7B's
    widths (`make_train_moe`: int8 g32 every linear, the experts included)
    on dp 2 × ep 2, the experts over ep and the batch's rows over dp with
    the whole batch's routing, each step against one process's step on the
    same batch and the leaves the ranks held before it (the first: the
    tree's own): each loss within TRAIN_LOSS_RTOL and grad_norm within
    TRAIN_TP_NORM_RTOL, the first step's gradients of the router, norms and
    head within TRAIN_GRAD_RTOL (relative L2); no kernel launched, the
    frozen bytes unchanged, every rank's metrics equal and its tree the one
    process's. One process's free-running steps are printed beside them.
    Returns a rank's launches (none)."""
    torch = sm.torch
    import tempfile

    label = f"train-moe ({TRAIN_MOE_RANKS} ranks over {TP_BACKEND} on one card)"
    print(f"{label}: {TRAIN_MOE_LABEL}, make_mesh(dp={TRAIN_MOE_DP}, ep={TRAIN_MOE_EP}), "
          f"{TRAIN_TP_STEPS} Adam steps (lr {TRAIN_LR}, remat, moe_aux_weight "
          f"{TRAIN_MOE_AUX}) of trainable_full on {TRAIN_TP_BATCH[0]} x {TRAIN_TP_BATCH[1]} "
          "inputs", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_ranks(sm, "train-moe", train_moe_rank, TRAIN_MOE_RANKS,
                                  TRAIN_MOE_TIMEOUT_S, tmp)
    t0 = time.perf_counter()
    cfg, params = make_train_moe(torch, "cuda", check=True)
    setup = time.perf_counter() - t0
    digest = tree_digest(torch, params)
    one = train_moe_run(torch, cfg, params)
    r0 = ranks[0]
    what = f"train-moe {TRAIN_MOE_LABEL}"
    # each later step from the leaves rank 0 held before it, in one process
    forced = [(one["losses"][0], one["norms"][0])]
    for leaves in r0["leaves"]:
        f = train_moe_run(torch, cfg, params, leaves=leaves)
        forced.append((f["losses"][0], f["norms"][0]))
    free_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"])]
    loss_rel = [abs(a - f[0]) / abs(f[0]) for a, f in zip(r0["losses"], forced)]
    norm_rel = [abs(a - f[1]) / f[1] for a, f in zip(r0["norms"], forced)]
    grad_rel = {p: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for p, a, b in zip(r0["paths"], r0["grads"], one["grads"])}
    held = {p: v for p, v in grad_rel.items() if any(n in p for n in TRAIN_MOE_HELD)}
    # each dp row's dropped pairs: its ep place 0 rank's
    rows = [ranks[d * TRAIN_MOE_EP]["drops"] for d in range(TRAIN_MOE_DP)]
    drops = [sum(row[l] for row in rows) for l in range(cfg.num_layers)]
    print(f"{what}: losses {r0['losses']} against one process's step on the same leaves "
          f"{[f[0] for f in forced]} ({[float(f'{x:.3g}') for x in loss_rel]} apart, limit "
          f"{TRAIN_LOSS_RTOL}); grad_norms {r0['norms']} against {[f[1] for f in forced]} "
          f"({[float(f'{x:.3g}') for x in norm_rel]} apart, limit {TRAIN_TP_NORM_RTOL}); one "
          f"process free-running: losses {one['losses']} ({[float(f'{x:.3g}') for x in free_rel]}"
          f" apart, not held), grad_norms {one['norms']}; first-step gradients, relative L2 "
          f"{ {p: round(v, 5) for p, v in grad_rel.items()} } (held: the router, norms and "
          f"head, limit {TRAIN_GRAD_RTOL}); metrics equal on all {TRAIN_MOE_RANKS} ranks, no "
          f"launch, frozen bytes unchanged; dropped (token, choice) pairs a layer of the first "
          f"forward: ranks {drops} (dp rows {rows}), one process {one['drops']}", flush=True)
    print(f"{what}: rank 0 set-up {r0['setup_s']:.2f} s, step wall ms "
          f"{[round(x, 1) for x in r0['ms']]} (one process "
          f"{[round(x, 1) for x in one['ms']]}), the steps' peak memory above what was held a "
          f"rank {[round(r['peak_gb'], 2) for r in ranks]} GB (held "
          f"{[round(r['held_gb'], 2) for r in ranks]}; one process {one['peak_gb']:.2f} above "
          f"{one['held_gb']:.2f}, the earlier phases' trees included); "
          f"one process's set-up {setup:.2f} s; collectives a rank over the "
          f"{TRAIN_TP_STEPS} steps and the first step's gradient gather {r0['collectives']}; "
          f"ranks' wall {wall:.1f} s ({smi.splitlines()[0]}); gloo moves CUDA tensors through "
          "the host, so these are functional numbers, not a parallel speed figure", flush=True)
    for r, res in enumerate(ranks):
        sm.expect(torch.equal(res["digest"], digest), f"{what}: rank {r}'s tree differs from "
                  "the one process's")
        sm.expect(res["local_experts"] == cfg.num_experts // TRAIN_MOE_EP,
                  f"{what}: rank {r} holds {res['local_experts']} experts")
        sm.expect((res["losses"], res["norms"]) == (r0["losses"], r0["norms"]),
                  f"{what}: rank {r}'s metrics {res['losses']} {res['norms']} against rank "
                  f"0's {r0['losses']} {r0['norms']}")
        sm.expect(not any(res["counts"].values()), f"{what}: rank {r} launched "
                  f"{res['counts']}")
        sm.expect(res["frozen_same"], f"{what}: a frozen leaf changed on rank {r}")
    sm.expect(not any(one["counts"].values()), f"{what}: one process launched {one['counts']}")
    sm.expect(one["frozen_same"], f"{what}: a frozen leaf changed in one process")
    sm.expect(len(r0["grads"]) == len(one["grads"]) and len(held) == 5,
              f"{what}: gradients of {list(grad_rel)}")
    sm.expect(max(loss_rel) <= TRAIN_LOSS_RTOL, f"{what}: losses {r0['losses']} against one "
              f"process's on the same leaves {forced}")
    sm.expect(max(norm_rel) <= TRAIN_TP_NORM_RTOL, f"{what}: grad_norms {r0['norms']} against "
              f"one process's on the same leaves {forced}")
    sm.expect(max(held.values()) <= TRAIN_GRAD_RTOL,
              f"{what}: first-step gradients against one process's {grad_rel}")
    del one, params
    torch.cuda.empty_cache()
    return r0["counts"]


def a8_calls_a_window(params, cfg) -> int:
    """The fused matvec calls of one decode window of a dense Llama: one for
    each act8 linear of a layer, fused or not, and lm_head's where it is
    quantized (a tied bf16 lm_head is a torch.matmul)."""
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor

    layers = params["layers"]
    per_layer = sum(isinstance(layers.get(n), QuantizedTensor)
                    for n in ("wqkv", "wq", "wk", "wv", "wo", "w13", "w1", "w3", "w2"))
    return per_layer * cfg.num_layers + isinstance(params["lm_head"], QuantizedTensor)


def spec_launches(counts, target, draft, n_draft: int, rounds: int, prefills: int):
    """The launches of ``prefills`` speculative calls of ``rounds`` greedy
    rounds in all, on dense caches in the activation dtype: a round is the
    draft's 2-token window, its ``n_draft - 2`` one-token steps (row 5 a
    layer each) and the target's ``n_draft``-token verify; windows of 2 or
    more tokens attend through the plain attention. A prefill is one flash
    launch a layer of each model."""
    (tp, tcfg), (dp, dcfg) = target, draft
    a8 = rounds * (a8_calls_a_window(dp, dcfg) * (n_draft - 1) + a8_calls_a_window(tp, tcfg))
    return {**dict.fromkeys(counts, 0), "a8_matvec": a8, "a8_quantize": a8,
            "decode_attention": rounds * dcfg.num_layers * (n_draft - 2),
            "flash_attention": prefills * (tcfg.num_layers + dcfg.num_layers)}


def make_1b_draft(torch):
    """Llama-3.2-1B at its published widths, random bf16 weights from a
    seeded torch.Generator, quantized as the CLI's ``--quantize w8a8`` does:
    per-channel int8, unfused (7 matvec calls a layer), the tied lm_head
    left in bf16."""
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.quant.quantize import quantize_params

    cfg = LlamaConfig.llama32_1b(max_seq_len=1024)
    dense = init_random_params(cfg, seed=1, dtype=torch.bfloat16, max_seq_len=1024,
                               device="cuda")
    return cfg, quantize_params(dense, bits=8, group_size=None, act_bits=8)


def near_tie(sm: Smoke, what: str, params, cfg, prompt, ids, got,
             quantized: bool = False) -> str:
    """Where speculative ids ``got`` part from the greedy ids ``ids`` of the
    one-token route: at the first such index j, the one-token route's
    logits (the prompt's prefill, then one-token steps over ids[:j] at
    host positions, as `eager_generate` runs), and beside them a 2-token
    verify window's first row on the same cache. The parting passes when
    the one-token route's top-2 gap lies within `check_logits`'s limit of
    its row, or when the one-token route chooses ``got[j]`` once its
    attention rounds the softmax weights to the cache's dtype before
    weighting the values, as a verify window's attention does (the JAX
    reference's cast, `ops.reference.attention`; row 5 keeps them in f32).
    Otherwise the phase fails. With ``quantized`` the one-token route runs
    on an int8 cache (row 3), as a context-parallel `generate` decodes."""
    torch = sm.torch
    import dataclasses

    from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
    from metalchat_tpu_torch.models import decode
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import reference

    diff = [i for i, (a, b) in enumerate(zip(got, ids)) if a != b]
    if not diff:
        return "identical"
    j, m, dev = diff[0], prompt.shape[1], prompt.device
    sm.expect(j > 0, f"{what}: the prefill's token differs ({got[0]} against {ids[0]})")
    cache = (QuantizedKVCache if quantized else KVCache).create(cfg, 1, m + j + 2, device=dev)
    forward(params, cache, prompt, 0, cfg)
    for i in range(j - 1):
        forward(params, cache, torch.tensor([[ids[i]]], device=dev), m + i, cfg)
    fields = [f.name for f in dataclasses.fields(cache)]
    snap = {n: getattr(cache, n).clone() for n in fields}

    def step(tokens):
        for n in fields:
            getattr(cache, n).copy_(snap[n])
        return forward(params, cache, torch.tensor([tokens], device=dev),
                       torch.tensor(m + j - 1, device=dev), cfg)[0][0, 0].float()

    def window_attention(q, k, v, layer, lengths, *, scale, window):
        pos = (lengths.long() - 1)[:, None]
        mask = reference.causal_mask(pos, k.shape[3], lengths[:, None, None],
                                     None if window < 0 else window)
        return reference.attention(q[:, None], k[layer], v[layer], mask, scale=scale)[:, 0]

    one = step([ids[j - 1]])
    win = step([ids[j - 1], got[j]])
    kernel_attention = decode.decode_attention_stacked
    decode.decode_attention_stacked = window_attention
    try:
        rounded = step([ids[j - 1]])
    finally:
        decode.decode_attention_stacked = kernel_attention
    top = torch.topk(one, 2)
    gap = (top.values[0] - top.values[1]).item()
    limit = RTOL["bfloat16"] * top.values[0].abs().item() + LOGIT_SHARE * one.abs().max().item()
    routes = (f"index {j} of {len(ids)}: one-token route {int(one.argmax())} (top-2 gap {gap}, "
              f"limit {limit}), verify window {int(win.argmax())} (max |window - one-token| "
              f"{(win - one).abs().max().item()}), one-token route with the window's "
              f"attention {int(rounded.argmax())}")
    sm.expect(int(one.argmax()) == ids[j],
              f"{what}: the one-token route does not reproduce its run's id at {routes}")
    if gap <= limit:
        return f"a near tie at {routes}"
    sm.expect(int(rounded.argmax()) == got[j],
              f"{what}: ids part with no near tie at {routes}")
    return (f"parted at {routes}: the window attention's rounded softmax weights alone "
            f"move the target's choice")


def phase_speculative(sm: Smoke, main, smi: str):
    """Speculative decoding at full width: the main phase's 8b-w4a8 params as
    the target, Llama-3.2-1B W8A8 as the draft, dense bf16 caches, the main
    prompt (512 tokens), SPEC_NEW new tokens at n_draft 4. The graph route's
    launches held exactly (`spec_launches`), one host read a round, three
    captures; its ids and both caches equal the JAX loop's (`_windows=False`,
    eager, a host read a draft) bit for bit; its ids equal `generate`'s
    greedy ids on a dense bf16 cache but at a near tie (`near_tie`). Then
    decode tok/s in turns (speculative, generate, generate, speculative) at
    ``_force_accept`` 3 and 0, SPEC_NEW / (t(SPEC_NEW + 1) - t(1)) each;
    each captured step's device ms (20 replays between CUDA events); the
    CLI's draft check (`measure_step_ratio`, `measure_verify_ratio`,
    `breakeven_accept_rate` at the measured verify cost), printed with the
    card's name and power limit."""
    torch = sm.torch
    import importlib

    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    spec = importlib.import_module("metalchat_tpu_torch.engine.speculative")
    tcfg, tparams, _, _, _, prompt = main
    t0 = time.perf_counter()
    dcfg, dparams = make_1b_draft(torch)
    torch.cuda.synchronize()
    print(f"speculative draft 1b-w8a8: {weight_bytes(dparams) / 1e9:.3f} GB of weights, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    m = prompt.shape[1]

    def caches(n_new):
        total = m + n_new + SPEC_DRAFT + 2
        return (KVCache.create(tcfg, 1, total, device=dev),
                KVCache.create(dcfg, 1, total, device=dev))

    def run(n_new, **kw):
        tc, dc = caches(n_new)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, stats = spec.speculative_generate(tparams, tcfg, dparams, dcfg, prompt,
                                               max_new_tokens=n_new, n_draft=SPEC_DRAFT,
                                               target_cache=tc, draft_cache=dc, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t, ids.tolist(), stats, (tc, dc), dict(spec.LAST_RUN)

    captures = []
    reset_launch_counts()
    with timed_captures(torch, spec, captures):
        wall, ids, stats, graph_caches, info = run(SPEC_NEW)
    counts = launch_counts()
    want = spec_launches(counts, (tparams, tcfg), (dparams, dcfg), SPEC_DRAFT, info["rounds"], 1)
    print(f"speculative 8b-w4a8 / 1b-w8a8: {len(ids)} tokens in {info['rounds']} rounds "
          f"({1e3 * wall:.1f} ms, prefills and captures included), stats {stats}, "
          f"{info['host_reads'] / info['rounds']:.2f} host reads a round, {info['captures']} "
          f"captures ({', '.join(f'{1e3 * s:.3f}' for s in captures)} ms); launches {counts}",
          flush=True)
    sm.expect(info["captures"] == 3 and info["host_reads"] == info["rounds"],
              f"speculative: {info}")
    sm.expect(counts == want, f"speculative: launches {counts} != expected {want}")

    _, eager_ids, eager_stats, eager_caches, eager_info = run(SPEC_NEW, _windows=False)
    sm.expect(eager_ids == ids and eager_stats == stats,
              f"speculative: graph route {ids} {stats} against the eager loop "
              f"{eager_ids} {eager_stats}")
    for g, e, model in zip(graph_caches, eager_caches, ("target", "draft")):
        sm.exact(g.k, e.k, f"speculative: {model} cache k, graph route against the eager loop")
        sm.exact(g.v, e.v, f"speculative: {model} cache v, graph route against the eager loop")
    ref = generate(tparams, tcfg, prompt, max_new_tokens=SPEC_NEW,
                   cache=KVCache.create(tcfg, 1, m + SPEC_NEW, device=dev))[0].tolist()
    verdict = near_tie(sm, "speculative", tparams, tcfg, prompt, ref, ids)
    print(f"speculative: graph route equal to the eager loop (ids, stats, both caches; the "
          f"loop made {eager_info['host_reads'] / eager_info['rounds']:.2f} host reads a "
          f"round); against generate's greedy ids: {verdict}", flush=True)

    def timed(route, n_new, force):
        if route == "speculative":
            return run(n_new, _force_accept=force)[0]
        cache = KVCache.create(tcfg, 1, m + n_new, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(tparams, tcfg, prompt, max_new_tokens=n_new, cache=cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    turns = {}
    for force in SPEC_FORCED:
        for route in ("speculative", "generate", "generate", "speculative"):
            first = timed(route, 1, force)
            total = timed(route, SPEC_NEW + 1, force)
            turns.setdefault(force, []).append((route, SPEC_NEW / (total - first)))
        rounds = spec.LAST_RUN["rounds"]
        print(f"speculative _force_accept={force}: decode tok/s in turns "
              + ", ".join(f"{r} {v:.2f}" for r, v in turns[force])
              + f" ({rounds} rounds for {SPEC_NEW + 1} tokens, dense bf16 caches, captures "
              f"included)", flush=True)
    # Where a round's time goes: the captured steps replayed 20 times between
    # CUDA events, each sequence one the round allows (a draft step follows
    # the window, which resets its position): the window alone, the window
    # and one step, the verify alone, and whole rounds without the host read.
    tc, dc = caches(SPEC_NEW)
    forward(tparams, tc, prompt, 0, tcfg)
    forward(dparams, dc, prompt, 0, dcfg)
    steps = spec.GreedyWindows(tparams, tcfg, tc, dparams, dcfg, dc, SPEC_DRAFT)
    steps.round(int(prompt[0, -1]), int(prompt[0, -2]), m)
    graphs = {key[0]: graph for key, graph in steps._graphs.items()}

    def replay_ms(names):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            for name in names:
                graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    window = replay_ms(["draft_window"])
    step_ms = {"draft_window": window,
               "draft_step": replay_ms(["draft_window", "draft_step"]) - window,
               "verify": replay_ms(["verify"]),
               "round": replay_ms(["draft_window"] + ["draft_step"] * (SPEC_DRAFT - 2)
                                  + ["verify"])}
    print(f"speculative round, device ms a replay: {step_ms}", flush=True)
    ratio = spec.measure_step_ratio(tparams, tcfg, dparams, dcfg)
    verify = spec.measure_verify_ratio(tparams, tcfg, n_draft=SPEC_DRAFT)
    alpha = spec.breakeven_accept_rate(ratio, n_draft=SPEC_DRAFT, verify_rel=verify)
    jax_alpha = spec.breakeven_accept_rate(ratio, n_draft=SPEC_DRAFT)
    sm.expect(verify > 0, f"speculative: measure_verify_ratio = {verify}")
    print(f"speculative draft check ({smi.splitlines()[0]}): measure_step_ratio(8b-w4a8, "
          f"1b-w8a8) = {ratio:.4f}, measure_verify_ratio(8b-w4a8, n_draft={SPEC_DRAFT}) = "
          f"{verify:.4f} target steps (the CLI's verify_rel; the JAX package's default 1.16), "
          f"breakeven_accept_rate(n_draft={SPEC_DRAFT}) = {alpha} (at verify_rel 1.16: "
          f"{jax_alpha})", flush=True)
    return counts


def phase_speculative_fixture(sm: Smoke):
    """The trained fixture in f32 (tie-free, as serve-fixture runs): the W4A8
    fused target and a W8A8 fused draft of the same weights, dense f32
    caches, the three 48-token prompts of eval_tokens[1440:1584], 32 new
    tokens each at n_draft 4: card against the CPU's plain path, the same
    ids and stats; the card's ids equal the target's greedy `generate`;
    launches exact."""
    torch = sm.torch
    import importlib

    import numpy as np

    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    spec = importlib.import_module("metalchat_tpu_torch.engine.speculative")
    runs, new, length = {}, 32, 96
    for where, device in (("cpu", "cpu"), ("card", "cuda")):
        tp, cfg, fixture = fixture_params(torch, device, torch.float32)
        dp, _, _ = fixture_params(torch, device, torch.float32, W8A8)
        tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
        prompts = torch.from_numpy(tokens[FIXTURE_INT_PROMPTS].reshape(3, 48)).to(device)
        reset_launch_counts()
        runs[where], rounds = [], 0
        for p in prompts:
            tc, dc = (KVCache.create(c, 1, length, dtype=torch.float32, device=device)
                      for c in (cfg, cfg))
            ids, stats = spec.speculative_generate(tp, cfg, dp, cfg, p[None], max_new_tokens=new,
                                                   n_draft=SPEC_DRAFT, target_cache=tc,
                                                   draft_cache=dc)
            runs[where].append((ids.tolist(), stats))
            rounds += spec.LAST_RUN["rounds"]
        if where == "card":
            counts = launch_counts()
            want = spec_launches(counts, (tp, cfg), (dp, cfg), SPEC_DRAFT, rounds, len(prompts))
            greedy = [generate(tp, cfg, p[None], max_new_tokens=new,
                               cache=KVCache.create(cfg, 1, length, dtype=torch.float32,
                                                    device=device))[0].tolist()
                      for p in prompts]
    rates = [s["accept_rate"] for _, s in runs["card"]]
    print(f"speculative-fixture (W4A8 target, W8A8 draft, f32): accept rates {rates}, "
          f"tokens a round {[s['tokens_per_iteration'] for _, s in runs['card']]}; card "
          f"equal to the CPU: {runs['card'] == runs['cpu']}; launches {counts}", flush=True)
    sm.expect(runs["card"] == runs["cpu"], f"speculative-fixture: card {runs['card']} "
              f"against the CPU {runs['cpu']}")
    sm.expect([ids for ids, _ in runs["card"]] == greedy,
              f"speculative-fixture: ids against generate's greedy {greedy}")
    sm.expect(counts == want, f"speculative-fixture: launches {counts} != expected {want}")
    return counts


# -- phases 6-8: serving ------------------------------------------------------

W4A8 = dict(bits=4, group_size=None, act_bits=8)


def fixture_params(torch, device, dtype=None, quant=None):
    """The trained fixture quantized by ``quant`` (W4A8 by default: per-channel
    int4, int8 activations), fused, activations in ``dtype`` (bf16 by
    default)."""
    from pathlib import Path

    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import quantize_params

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    cfg = load_config(fixture / "config.json")
    params = load_params(open_safetensors(fixture), cfg, dtype=dtype or torch.bfloat16,
                         max_seq_len=256, device=device)
    return fuse_projections(quantize_params(params, **(quant or W4A8)), cfg), cfg, fixture


# fixture-int runs in bf16, the activation dtype of the main paths. Its
# greedy tokens are compared on eval_tokens[1440:1584]: bf16 logits are
# coarse, and over most slices of the eval tokens some mode's top two logits
# at one of the 48 positions compared lie within 0-2 bf16 steps of each
# other, where two sum orders may part (eval_tokens[:144]: 2 steps in
# "w8 g32", at which card and CPU parted at the 7th token of request 0,
# 5.875 against 5.84375). This slice keeps every gap at 15 steps or more
# (experiments/fixture_tie_scan.py, on the CPU).
FIXTURE_INT_DTYPE = "bfloat16"
FIXTURE_INT_PROMPTS = slice(1440, 1584)
# Beside the tokens, the logits step by step on eval_tokens[:144], which does
# not rest on a tie-free slice: a prefill and FIXTURE_INT_LOGIT_STEPS - 1
# decode steps fed the CPU's greedy tokens on both devices, the last
# position's logits of each step on the card within one bf16 step of the
# CPU's plus LOGIT_SHARE of the row's largest |logit|. Row 11's own schedule
# (emulated on the CPU, tests/test_torch_qmm_mma.py) moves them by at most
# 0.0051 of the largest beyond one step in "w8 g32" and "w4 g32"; a split
# dropped from the k-split merge moves them by 0.89.
FIXTURE_INT_LOGIT_PROMPTS = slice(0, 144)
# The stream phase's fixture prompt: greedy continuations of the fixture's
# Python source often settle into runs of one id (spaces after an indent,
# eval_tokens[1440:1488]); this one varies. It runs in f32, as serve-fixture
# does, so that no bf16 near tie parts card and CPU.
STREAM_FIXTURE_PROMPT = slice(200, 248)
FIXTURE_INT_LOGIT_STEPS = 16
LOGIT_SHARE = 2 ** -5
# fixture-int: the modes, as (quantization, generate's ffn_block). Weight-only
# group-32 leaves take the dequant-matmul kernel at decode (3 rows) and a
# dense product for the 144-row prompt; lm_head is quantized too.
FIXTURE_INT_MODES = {
    "w4 g32": (dict(bits=4, group_size=32, quantize_lm_head=True), False),
    "w8 g32": (dict(bits=8, group_size=32, quantize_lm_head=True), False),
    "w4a8 ffn_block": (W4A8, True),
}


def teacher_forced_logits(params, cfg, prompts, tokens, ffn_block: bool = False):
    """``[steps, B, vocab]`` f32 on the CPU, ``steps = tokens.shape[1]``: the
    last position's logits of a prefill over ``prompts``, then of one decode
    step per column of ``tokens`` but the last, each fed that column, on an
    int8 cache as ``generate`` makes it."""
    import torch

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    device = params["final_norm"].device
    prompts, tokens = prompts.to(device), tokens.to(device)
    b, s = prompts.shape
    steps = tokens.shape[1]
    with torch.no_grad():
        cache = QuantizedKVCache.create(cfg, b, min(cfg.max_seq_len, s + steps),
                                        device=device)
        logits, cache = forward(params, cache, prompts, 0, cfg, ffn_block=ffn_block)
        out = [logits[:, -1].float().cpu()]
        for i in range(steps - 1):
            logits, cache = forward(params, cache, tokens[:, i:i + 1], s + i, cfg,
                                    ffn_block=ffn_block)
            out.append(logits[:, -1].float().cpu())
    return torch.stack(out)


def logit_limit(want):
    """`check_logits`'s limit for each of ``want``'s logits."""
    return RTOL["bfloat16"] * want.abs() + LOGIT_SHARE * want.abs().amax(-1, keepdim=True)


def check_logits(sm: Smoke, what: str, got, want) -> float:
    """Each step's logits within one bf16 step of each value plus
    ``LOGIT_SHARE`` of the row's largest |logit|; returns the worst share of
    that limit."""
    torch = sm.torch
    diff = (got - want).abs()
    limit = logit_limit(want)
    share = (diff / limit).max().item()
    sm.expect(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    sm.expect(share <= 1.0, f"{what}: {int((diff > limit).sum())} logits beyond the limit "
              f"(max abs err {diff.max().item()}, {share:.3g} of the limit)")
    return share


def phase_fixture_int(sm: Smoke, dtype_name: str):
    """The fixture through `generate` in each FIXTURE_INT_MODES mode, the
    kernels on the card against the plain path on the CPU: 3 requests of 48
    tokens, 64 greedy tokens; the first 16 of each request must agree. Then
    each step's logits on FIXTURE_INT_LOGIT_PROMPTS, fed the CPU's tokens
    (``check_logits``)."""
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    dtype = getattr(torch, dtype_name)
    results = {}
    for mode, (quant, ffn_block) in FIXTURE_INT_MODES.items():
        outs, logits, forced = {}, {}, None
        for device in ("cpu", "cuda"):
            params, cfg, fixture = fixture_params(torch, device, dtype, quant)
            tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
            prompts = torch.from_numpy(tokens[FIXTURE_INT_PROMPTS].reshape(3, 48))
            reset_launch_counts()
            outs[device] = generate(params, cfg, prompts, max_new_tokens=64,
                                    quantized_kv=True, ffn_block=ffn_block).cpu()
            if device == "cuda":
                counts = launch_counts()
            old = torch.from_numpy(tokens[FIXTURE_INT_LOGIT_PROMPTS].reshape(3, 48))
            if forced is None:  # the CPU's greedy tokens
                forced = generate(params, cfg, old, max_new_tokens=FIXTURE_INT_LOGIT_STEPS,
                                  quantized_kv=True, ffn_block=ffn_block).cpu()
            logits[device] = teacher_forced_logits(params, cfg, old, forced, ffn_block)
        agree = (outs["cuda"] == outs["cpu"]).float().mean().item()
        first16 = bool(torch.equal(outs["cuda"][:, :16], outs["cpu"][:, :16]))
        print(f"fixture-int {mode} {dtype_name}: card vs CPU plain agreement {agree:.4f}, "
              f"first 16 identical: {first16}, launches {counts}; logits step by step on "
              f"eval_tokens[:144]: max abs err "
              f"{(logits['cuda'] - logits['cpu']).abs().max().item()}", flush=True)
        share = check_logits(sm, f"fixture-int {mode} logits on eval_tokens[:144]",
                             logits["cuda"], logits["cpu"])
        print(f"fixture-int {mode}: logits worst {share:.4f} of the limit")
        sm.expect(first16, f"fixture-int {mode}: first 16 greedy tokens differ card vs CPU")
        kernel = "ffn_block" if ffn_block else "quant_matmul"
        sm.expect(counts[kernel] > 0 and counts["decode_attention_update"] > 0,
                  f"fixture-int {mode}: a kernel never ran {counts}")
        results[mode] = counts
    return results


SERVE_FIXTURE = dict(max_slots=3, max_seq_len=256, prefill_chunk=32, decode_burst=4)
SERVE_FIXTURE_MODES = {"paged": dict(cache_mode="paged", page_size=16),
                       "dense": dict(quantized_kv=True),
                       "dense-act": dict()}  # KV in the activation dtype
SERVE_FIXTURE_LENGTHS = (5, 70, 35, 15, 48, 120)
# The mixed-sampler run: per request (SERVE_FIXTURE_LENGTHS) greedy or
# (temperature, top-k, top-p), so that bursts take all three sampling branches.
SERVE_FIXTURE_MIXED = (None, (0.8, 0, 1.0), None, (0.8, 20, 0.9), (0.8, 20, 0.9), None)
# A drawn id's row keeps it when fewer than top-k scaled logits lie above it
# and the probability mass above it (f64) is below top-p; the mass is held
# with this margin, as the sampler's f32 bisection sums it in another order.
KEPT_MASS_MARGIN = 1e-5


def eager_burst_engine(params, cfg, **kw):
    """The engine with the decode burst it ran before its step was captured
    (a loop of eager `forward` calls fed from the host's staged rows, the
    sampler given host sequences), written here as the graph route's
    reference, as `eager_generate` is for `generate`."""
    import torch

    from metalchat_tpu_torch.engine import ContinuousBatchingEngine
    from metalchat_tpu_torch.sampling import sample_batched

    class EagerBurstEngine(ContinuousBatchingEngine):
        def _run_burst(self, steps, branch):
            h, dev = self._host, self.device
            tok = torch.from_numpy(h["tokens"]).to(dev, torch.long)
            pos = torch.from_numpy(h["positions"]).to(dev)
            adv = torch.from_numpy(h["advance"]).to(dev)
            out = []
            for _ in range(steps):
                logits = self._forward(self.cache, tok[:, None], pos)
                tok = sample_batched(logits[:, 0], self._gen, h["temperature"], h["top_k"],
                                     h["top_p"])
                pos = pos + adv
                out.append(tok)
            return torch.stack(out)

    return EagerBurstEngine(params, cfg, **kw)


def recording_engine(params, cfg, **kw):
    """The graph-route engine with each burst step's logits written, inside
    the captured step, into a buffer at the step index; `bursts` keeps each
    dispatch's (settings, tokens, logits) for `check_kept`."""
    import torch

    from metalchat_tpu_torch.engine import ContinuousBatchingEngine

    class RecordingEngine(ContinuousBatchingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.bursts = []
            self._log = torch.zeros((self.decode_burst, self.max_slots, cfg.vocab_size),
                                    device=self.device)

        def _forward(self, cache, tokens, start_pos):
            logits = super()._forward(cache, tokens, start_pos)
            if start_pos is self._rows["positions"]:  # a burst step
                self._log.index_copy_(0, self._rows["step"].long(), logits[:, 0][None])
            return logits

        def _run_burst(self, steps, branch):
            out = super()._run_burst(steps, branch)
            settings = {k: self._host[k].copy() for k in ("temperature", "top_k", "top_p")}
            self.bursts.append((settings, out.clone(), self._log[:steps].clone()))
            return out

    return RecordingEngine(params, cfg, **kw)


def check_kept(sm: Smoke, what: str, bursts) -> int:
    """Every drawn id of every recorded burst step lies in its row's kept
    set (see KEPT_MASS_MARGIN); returns the number of drawn ids checked."""
    torch = sm.torch
    checked = 0
    for settings, toks, logits in bursts:
        dev = logits.device
        t, k, p = (torch.from_numpy(settings[n]).to(dev) for n in ("temperature", "top_k",
                                                                    "top_p"))
        drawn = t > 0
        x = logits.double() / torch.where(drawn, t, 1.0).double()[None, :, None]
        above = x > x.gather(-1, toks[..., None])
        count = above.sum(-1)
        mass = (torch.softmax(x, dim=-1) * above).sum(-1)
        ok = ((k <= 0) | (count < k)) & ((p >= 1) | (mass < p + KEPT_MASS_MARGIN))
        sm.expect(bool((ok | ~drawn).all()),
                  f"{what}: {int((~ok & drawn).sum())} drawn ids outside their kept sets")
        checked += int(drawn.sum()) * toks.shape[0]
    return checked


@contextlib.contextmanager
def timed_captures(torch, module=None, seconds=None):
    """A context in which ``module`` (default `engine.serving`) captures
    through a CountedGraph that records each capture's wall time
    (synchronized) on the graph, and appends it to ``seconds`` if given."""
    if module is None:
        from metalchat_tpu_torch.engine import serving as module

    base = module.CountedGraph

    class Timed(base):
        def capture(self, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = super().capture(fn)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t
            if seconds is not None:
                seconds.append(self.seconds)
            return out

    module.CountedGraph = Timed
    try:
        yield
    finally:
        module.CountedGraph = base


def graph_report(torch, engine) -> str:
    """The engine's captured steps: their branches, each capture's ms and
    the bytes of the engine's graph memory pool."""
    pool = engine._pool
    nbytes = 0 if pool is None else sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
    ms = {b: round(1e3 * g.seconds, 3) for b, g in engine._graphs.items()}
    return f"{len(engine._graphs)} captures (ms by branch {ms}), graph pool {nbytes} bytes"


def cache_tensors(engine):
    import dataclasses

    return {f.name: getattr(engine.cache, f.name) for f in dataclasses.fields(engine.cache)}


def phase_serve_fixture(sm: Smoke):
    """6 greedy requests of mixed lengths through the engine, paged, dense
    int8 and dense in the activation dtype, at f32 activations: on the card
    (the graph route) against the CPU plain path (first 16 tokens), and
    against `eager_burst_engine` on the card (ids, every cache tensor and the
    launch counts, bit for bit). Then the mixed-sampler run on the card,
    paged (`SERVE_FIXTURE_MIXED`): greedy rows equal to the eager engine's,
    every drawn id of the captured steps in its kept set (`check_kept`), and
    two runs under one seed identical. (In bf16 the 70-token request meets a
    near tie at its 15th token: on the card token 61 scores 6.6875 over
    token 41's 6.59375, on the CPU token 41 scores 6.625 over token 61's
    6.59375, paged and dense alike.)"""
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.sampling import SamplerConfig

    tokens = None
    out, counts = {}, {}

    def run(key, engine, samplers=None):
        reset_launch_counts()
        done = engine.run([Request(prompt=p, max_new_tokens=16,
                                   sampler=SamplerConfig(*c) if c else SamplerConfig.greedy())
                           for p, c in zip(prompts, samplers or [None] * len(prompts))])
        counts[key] = launch_counts()
        out[key] = [c.tokens for c in done.values()]
        sm.expect(all(c.finish_reason == "length" for c in done.values()),
                  f"serve-fixture {key}: {[c.finish_reason for c in done.values()]}")
        return engine

    for device in ("cuda", "cpu"):
        params, cfg, fixture = fixture_params(torch, device, torch.float32)
        if tokens is None:
            tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
        prompts = [tokens[1000 + 100 * i:1000 + 100 * i + n].tolist()
                   for i, n in enumerate(SERVE_FIXTURE_LENGTHS)]
        for mode, kw in SERVE_FIXTURE_MODES.items():
            engine = run((device, mode), ContinuousBatchingEngine(
                params, cfg, **SERVE_FIXTURE, **kw))
            if device == "cpu":
                continue
            eager = run(("eager", mode), eager_burst_engine(params, cfg, **SERVE_FIXTURE,
                                                            **kw))
            sm.expect(out["cuda", mode] == out["eager", mode],
                      f"serve-fixture {mode}: graph route ids differ from the eager loop's")
            for name, t in cache_tensors(engine).items():
                sm.exact(t, cache_tensors(eager)[name],
                         f"serve-fixture {mode}: cache {name}, graph route against the "
                         "eager loop")
            sm.expect(counts["cuda", mode] == counts["eager", mode],
                      f"serve-fixture {mode}: launches {counts['cuda', mode]} against the "
                      f"eager loop's {counts['eager', mode]}")
            print(f"serve-fixture {mode}: graph route ids, caches and launches equal "
                  f"to the eager loop's; {graph_report(torch, engine)}", flush=True)
        if device == "cuda":  # the mixed-sampler run
            kw = dict(**SERVE_FIXTURE, **SERVE_FIXTURE_MODES["paged"])
            rec = run("mixed", recording_engine(params, cfg, **kw), SERVE_FIXTURE_MIXED)
            run("mixed again", ContinuousBatchingEngine(params, cfg, **kw),
                SERVE_FIXTURE_MIXED)
            run("mixed eager", eager_burst_engine(params, cfg, **kw), SERVE_FIXTURE_MIXED)
            run("mixed seed 1", ContinuousBatchingEngine(params, cfg, seed=1, **kw),
                SERVE_FIXTURE_MIXED)
            checked = check_kept(sm, "serve-fixture mixed", rec.bursts)
            greedy = [i for i, c in enumerate(SERVE_FIXTURE_MIXED) if c is None]
            sm.expect(sorted(rec._graphs) == ["draw", "greedy", "truncate"],
                      f"serve-fixture mixed: captured branches {sorted(rec._graphs)}")
            sm.expect(out["mixed"] == out["mixed again"] != out["mixed seed 1"],
                      "serve-fixture mixed: two runs under one seed differ, or seeds 0 "
                      "and 1 draw the same ids")
            sm.expect(all(out["mixed"][i] == out["mixed eager"][i] for i in greedy),
                      "serve-fixture mixed: greedy rows differ from the eager loop's")
            print(f"serve-fixture mixed samplers (paged): {checked} drawn ids in their "
                  f"kept sets, two runs under seed 0 identical (seed 1 differs), greedy "
                  f"rows equal to the "
                  f"eager loop's, drawn rows equal to the eager loop's: "
                  f"{out['mixed'] == out['mixed eager']}; {graph_report(torch, rec)}",
                  flush=True)

    def first16(a, b):
        return all(x[:16] == y[:16] for x, y in zip(out[a], out[b]))

    def first_diff(a, b):
        return [next((i for i, (s, t) in enumerate(zip(x, y)) if s != t), None)
                for x, y in zip(out[a], out[b])]

    def agree(a, b):
        pairs = [(s, t) for x, y in zip(out[a], out[b]) for s, t in zip(x, y)]
        return sum(s == t for s, t in pairs) / len(pairs)

    for mode in SERVE_FIXTURE_MODES:
        print(f"serve-fixture {mode}: card vs CPU plain agreement "
              f"{agree(('cuda', mode), ('cpu', mode)):.4f}, first 16 identical: "
              f"{first16(('cuda', mode), ('cpu', mode))} (first difference per request "
              f"{first_diff(('cuda', mode), ('cpu', mode))}), launches {counts['cuda', mode]}")
        sm.expect(first16(("cuda", mode), ("cpu", mode)),
                  f"serve-fixture {mode}: first 16 greedy tokens differ card vs CPU")
    print(f"serve-fixture paged vs dense on the card: agreement "
          f"{agree(('cuda', 'paged'), ('cuda', 'dense')):.4f}")
    sm.expect(first16(("cuda", "paged"), ("cuda", "dense")),
              "serve-fixture: paged and dense differ on the card")
    for mode, attn in (("paged", "paged_decode_attention_update"),
                       ("dense", "decode_attention_update"), ("dense-act", "decode_attention")):
        c = counts["cuda", mode]
        sm.expect(c[attn] > 0 and c["a8_matvec"] > 0 and c["flash_attention"] > 0,
                  f"serve-fixture {mode}: a kernel never ran {c}")
    return {mode: counts["cuda", mode] for mode in SERVE_FIXTURE_MODES}


def serve_workload(cfg, n: int = 24, new: int = 96):
    """`bench.py --mode serve`'s requests: prompt lengths from
    random.Random(0).randint(48, 640), prompt [1 + i % 100] * n, greedy."""
    import random

    from metalchat_tpu_torch.engine import Request

    rng = random.Random(0)
    hi = min(640, cfg.max_seq_len - new - 8)
    lengths = [rng.randint(min(48, hi), hi) for _ in range(n)]
    return [Request(prompt=[1 + (i % 100)] * k, max_new_tokens=new)
            for i, k in enumerate(lengths)]


def serve_bytes_per_token(cfg, params, slots: int) -> float:
    """bench.py's bytes_per_token for an int8 cache: weights but the
    embedding table, one embedding row, and each row's KV payload and
    scales at the average fill max_seq_len / 2."""
    kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * (cfg.max_seq_len / 2) * (cfg.head_dim + 4)
    return weight_bytes(params) + cfg.hidden_size * 2 + slots * kv_row


SERVE_MODES = {"paged": dict(cache_mode="paged", page_size=256),
               "dense": dict(quantized_kv=True)}


# One eager turn between two graph turns: Mixtral's eager-loop engine takes
# about 47 s for the workload (833 matvec launches a step from the host),
# GPT-2 XL's about 22 s (48 layers of eager glue), and serve's and
# serve-gemma's second eager turn (3.6-4.4 s a cache mode on an H100) was cut
# for the script's time limit.
SERVE_TURNS = ("graph", "eager", "graph")
# Each serve phase's depth: its generate phase's model cut to the first
# layers (`first_layers`), so that the script stays inside its time limit
# (serve-mixtral took 141 s and serve 93 s at full depth on an H100; at 8 and
# 16 layers 46.1 and 53.2 s, the script 846.7 s with phase tp, so the depths
# were halved again). Widths, the workload and the turns are unchanged
# (Gemma's 7 layers hold a global one); the generate phases run every layer.
SERVE_LAYERS = {"serve": 8, "serve-gemma": 7, "serve-mixtral": 4, "serve-gpt2": 8}


def first_layers(run, n: int, what: str, quiet: bool = False):
    """``run``'s config and params (its first two items) cut to their first
    ``n`` layers: the depth replaced, every stacked layer leaf sliced
    (views, no copy), everything else shared; the cut printed unless
    ``quiet``."""
    import dataclasses

    from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

    def cut(leaf):
        if isinstance(leaf, QuantizedTensor):
            return dataclasses.replace(leaf, q=leaf.q[:n], scales=leaf.scales[:n])
        if isinstance(leaf, LoraLinear):
            return dataclasses.replace(leaf, base=cut(leaf.base), a=leaf.a[:n], b=leaf.b[:n])
        return leaf[:n]

    cfg, params = run[0], run[1]
    if not quiet:
        print(f"{what}: the model cut to its first {n} of {cfg.num_layers} layers", flush=True)
    return cfg.replace(num_layers=n), {**params, "layers": {
        k: cut(v) for k, v in params["layers"].items()}}


def matvec_calls(cfg, rows: int, lm_head: bool = True):
    """The fused matvec calls of one decode window of ``rows`` rows, by
    launch counter: 4 a layer and lm_head for a dense FFN; for MoE, wqkv
    and wo a layer and lm_head at host indices, and the experts: 3 a
    routed (row, choice) at a device index when rows·K ≤ E/2, else 3 an
    expert at host indices (`models/decode._moe_ffn_decode`). Without
    ``lm_head`` the head is a dense product (GPT-2's bf16 head)."""
    L, head = cfg.num_layers, int(lm_head)
    if not cfg.num_experts:
        calls = {"a8_matvec": 4 * L + head}
    elif rows * cfg.num_experts_per_tok <= cfg.num_experts // 2:
        calls = {"a8_matvec": 2 * L + head,
                 "a8_matvec_indexed": 3 * L * rows * cfg.num_experts_per_tok}
    else:
        calls = {"a8_matvec": (2 + 3 * cfg.num_experts) * L + head}
    calls["a8_quantize"] = sum(calls.values())
    return calls


def phase_serve(sm: Smoke, main, rate: float, label: str = "8b-w4a8",
                modes=tuple(SERVE_MODES), turns=SERVE_TURNS):
    """``main``'s model behind the engine with bench.py's serve workload, in
    each of ``modes`` (paged, dense int8): the graph route and
    `eager_burst_engine` in ``turns``, each engine after a
    2-request warm-up (the graph engine's captures). Every turn's launch
    counts, read around its run, held exactly to its counters and prompt
    chunks; every turn's ids equal to the first's. Then the graph engine's
    wall by dispatch kind (`dispatch_breakdown`) and one decode dispatch of
    8 steps, every slot decoding, under the profiler, on each route."""
    torch = sm.torch
    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor
    from metalchat_tpu_torch.utils.profiling import Meter

    cfg, params = main[0], main[1]
    L = cfg.num_layers
    head = isinstance(params["lm_head"], QuantizedTensor)
    slots, new = 8, 96
    requests = serve_workload(cfg, new=new)
    bpt = serve_bytes_per_token(cfg, params, slots)
    roof = rate / bpt * slots

    def fresh(rs):
        return [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens) for r in rs]

    def measured(engine, route, mode):
        engine.meter = Meter()
        engine.counters = dict.fromkeys(engine.counters, 0)
        engine.prefill_shapes.clear()
        torch.cuda.synchronize()
        reset_launch_counts()
        engine.meter.start()
        t0 = time.perf_counter()
        done = engine.run(fresh(requests))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        m = engine.metrics()
        total = sum(len(c.tokens) for c in done.values())
        tok_s = total / wall
        steps = m["decode_steps"]
        # Prompt chunks by shape: windows of <= 16 tokens take the decode
        # path (the matvec kernel when B*S <= 16 rows; the attention kernel
        # when S == 1), but on a paged cache only single tokens do (windows
        # of 2-16 tokens take the layer route's plain products there, as in
        # the JAX package); longer ones flash attention.
        shapes = engine.prefill_shapes
        short = {(b, s): n for (b, s), n in shapes.items() if s <= 16 and b * s <= 16
                 and (s == 1 or mode != "paged")}
        single = sum(n for (b, s), n in shapes.items() if s == 1)
        long_ = sum(n for (b, s), n in shapes.items() if s > 16)
        attn = "paged_decode_attention_update" if mode == "paged" else "decode_attention_update"
        # a8_quantize once for each fused matvec call, of any row count.
        want = {attn: L * (steps + single), "flash_attention": L * long_}
        for rows, n in [(slots, steps)] + [(b * s, n) for (b, s), n in short.items()]:
            for k, c in matvec_calls(cfg, rows, head).items():
                want[k] = want.get(k, 0) + c * n
        print(f"serve {label} {mode} {route}: {len(done)} requests, {total} tokens in "
              f"{wall:.3f} s = {tok_s:.2f} tok/s, {tok_s / roof:.4f} of the full-slot decode "
              f"roofline ({roof:.1f} tok/s at {bpt / 1e9:.4f} GB a step, "
              f"{rate / 1e12:.2f} TB/s); TTFT p50 {1e3 * m['ttft_p50']:.1f} ms p99 "
              f"{1e3 * m['ttft_p99']:.1f} ms, service TTFT p50 "
              f"{1e3 * m['service_ttft_p50']:.1f} ms p99 {1e3 * m['service_ttft_p99']:.1f} ms; "
              f"counters { {k: m[k] for k in engine.counters} }; prompt chunks by shape "
              f"{dict(shapes)} ({sum(short.values())} short, {long_} long); launches "
              f"{counts}", flush=True)
        sm.expect(all(c.error is None and c.finish_reason == "length"
                      and len(c.tokens) == new for c in done.values())
                  and len(done) == len(requests),
                  f"serve {label} {mode} {route}: "
                  f"{[(c.finish_reason, len(c.tokens)) for c in done.values()]}")
        sm.expect(sum(shapes.values()) == m["prefill_dispatches"] + m["combined_dispatches"],
                  f"serve {label} {mode} {route}: prompt chunks {dict(shapes)} vs counters {m}")
        want = {**dict.fromkeys(counts, 0), **want}  # every other kernel: never
        sm.expect(counts == want,
                  f"serve {label} {mode} {route}: launches {counts} != expected {want}")
        if mode == "paged":
            sm.expect(engine.allocator.free_pages == engine.num_pages,
                      f"serve paged {route}: "
                      f"{engine.num_pages - engine.allocator.free_pages} pages never freed")
        return dict(counts=counts, tok_s=tok_s, metrics=m,
                    ids=[c.tokens for c in done.values()])

    runs = {}
    for mode in modes:
        kw = dict(max_slots=slots, max_seq_len=1024, decode_burst=32, prefill_chunk=256,
                  **SERVE_MODES[mode])
        engines = {"graph": ContinuousBatchingEngine(params, cfg, **kw),
                   "eager": eager_burst_engine(params, cfg, **kw)}
        for engine in engines.values():
            engine.run(fresh(requests[:2]))  # warm-up
        by_turn = [(route, measured(engines[route], route, mode)) for route in turns]
        for route, t in by_turn[1:]:
            sm.expect(t["ids"] == by_turn[0][1]["ids"],
                      f"serve {label} {mode}: the {route} route's ids differ from the graph "
                      "route's")
        graph = engines["graph"]
        dispatch_breakdown(torch, graph, fresh(requests), f"serve {label} {mode} graph")
        sm.expect(list(graph._graphs) == ["greedy"],
                  f"serve {label} {mode}: captured branches {list(graph._graphs)}")
        print(f"serve {label} {mode}: tok/s in turns "
              + ", ".join(f"{r} {t['tok_s']:.2f}" for r, t in by_turn)
              + f"; ids of every turn equal; graph engine: {graph_report(torch, graph)}",
              flush=True)
        if mode == "paged":  # one decode dispatch (8 steps), every slot decoding
            for route, engine in engines.items():
                fill_slots(engine, requests, slots)
                engine.decode_burst = 8
                profile_window(torch, f"serve {label} {mode} {route} route, one decode "
                               f"dispatch of {slots} rows", engine.step)
                for rid in list(engine._completions):
                    engine.cancel(rid)
        first = by_turn[0][1]
        runs[mode] = dict(engine=graph, counts=first["counts"], tok_s=first["tok_s"],
                          metrics=first["metrics"])
    return runs


def dispatch_breakdown(torch, engine, requests, what: str) -> None:
    """One more run of ``requests`` with the card synchronized after each
    engine step: wall seconds and count by dispatch kind (prompt chunks
    alone, decode bursts, prompt chunk + burst), so the report says which
    kind sets the serve pace."""
    kinds = ("prefill_dispatches", "decode_dispatches", "combined_dispatches")
    wall, count = dict.fromkeys(kinds, 0.0), dict.fromkeys(kinds, 0)
    for r in requests:
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work:
        before = dict(engine.counters)
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        kind = next((k for k in kinds if engine.counters[k] != before[k]), None)
        if kind is not None:
            wall[kind] += time.perf_counter() - t
            count[kind] += 1
    total = time.perf_counter() - t0
    print(f"{what}, each step synchronized: {total:.3f} s, by dispatch kind "
          + ", ".join(f"{k.removesuffix('_dispatches')} {count[k]} in {wall[k]:.3f} s"
                      for k in kinds), flush=True)


def fill_slots(engine, requests, slots: int) -> None:
    """Admit and prefill one request per slot, up to their first token."""
    from metalchat_tpu_torch.engine import Request

    for r in requests[:slots]:
        engine.submit(Request(prompt=list(r.prompt), max_new_tokens=64))
    for _ in range(100):
        if len(engine._slots) == slots and all(s.decoding for s in engine._slots.values()):
            return
        engine.step()
    raise AssertionError("serve: the slots did not fill")


class ByteTokenizer:
    """Byte-level tokenizer: ids are bytes (the fixture was trained on them)."""

    def encode(self, text, allow_special=False):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")

    def token_bytes(self, token_id):
        return bytes([int(token_id) % 256])


def phase_http(sm: Smoke):
    """The fixture (paged, on the card) behind InferenceServer on 127.0.0.1."""
    torch = sm.torch
    import urllib.request

    from metalchat_tpu_torch.engine import ContinuousBatchingEngine
    from metalchat_tpu_torch.engine.http import InferenceServer

    params, cfg, _ = fixture_params(torch, "cuda")
    engine = ContinuousBatchingEngine(params, cfg, **SERVE_FIXTURE,
                                      **SERVE_FIXTURE_MODES["paged"])
    server = InferenceServer(engine, ByteTokenizer(), model_name="fixture")
    port = server.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=60)

    try:
        payload = {"prompt": "The history of the ", "max_tokens": 16}
        with post("/v1/completions", payload) as r:
            text = json.loads(r.read())["choices"][0]["text"]
        chunks = []
        with post("/v1/completions", {**payload, "stream": True}) as r:
            for line in r:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    break
                if line.startswith("data: "):
                    chunks.append(json.loads(line[6:])["choices"][0]["text"])
        with post("/v1/chat/completions", {"messages": [{"role": "user", "content": "Hi"}],
                                           "max_tokens": 8}) as r:
            chat = json.loads(r.read())
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        server.stop()
    print(f"http: blocking {text!r}, SSE equal: {''.join(chunks) == text}, chat "
          f"{chat['choices'][0]['message']['content']!r}, health {health}, metrics "
          f"requests {metrics.get('requests')}, decode_steps {metrics.get('decode_steps')}; "
          f"{graph_report(torch, engine)}")
    sm.expect(len(engine._graphs) > 0, "http: the engine captured no decode step")
    sm.expect(len(text) > 0 and "".join(chunks) == text, "http: SSE text != blocking text")
    sm.expect(chat["object"] == "chat.completion" and health == {"status": "ok"}
              and metrics.get("requests") == 3.0, f"http: {chat} {health} {metrics}")


# -- text, chat and the CLI ----------------------------------------------------------

CHAT_CTX, CHAT_SINKS = 1024, 4
# Each turn: its messages as (role, tokens of text), and its reply limit.
# Turn 1 fills about 650 positions with its reply; turn 2's prompt is
# prefilled by flash from there and its reply crosses position 1023.
CHAT_TURNS = (((("system", 24), ("user", 530)), 64), ((("user", 300),), 128))
CHAT_RANKS = 128000  # Llama-3's byte-pair ranks; its 256 specials follow
# meta-llama/Llama-3.2-1B's config.json.
LLAMA32_1B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 2048,
    "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "vocab_size": 128256,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "tie_word_embeddings": True, "bos_token_id": 128000, "eos_token_id": 128001,
    "torch_dtype": "bfloat16"}
FIXTURE_PROMPT = "def main():\n    "  # tests/test_fixture_e2e.py's PROMPT
# tests/test_fixture_e2e.py's GOLDEN: its greedy continuation in f32 on the CPU.
FIXTURE_GOLDEN = [32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 35, 32, 67, 114,
                  101, 97, 116, 101, 32, 97, 32, 99, 108, 105, 101, 110, 116, 10, 32, 32]
# Runs the CLI's `checkout` in a process of its own and reports its launches
# and its session's turns on the last line of stderr.
CHECKOUT_DRIVER = """
import dataclasses, json, sys
from metalchat_tpu_torch.cli import main as cli
from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
sessions, load = [], cli._load_session
cli._load_session = lambda ref, args: sessions.append(load(ref, args)) or sessions[-1]
reset_launch_counts()
rc = cli.main(sys.argv[1:])
s = sessions[0]
print(json.dumps({"launches": launch_counts(), "captures": s.captures,
                  "turns": [dataclasses.asdict(t) for t in s.turns]}), file=sys.stderr)
sys.exit(rc)
"""


def write_llama3_tokenizer(path, seed: int = 0) -> None:
    """A tiktoken ``tokenizer.model`` in Llama-3's layout: 128,000 ranks, the
    256 bytes, the 65,536 byte pairs and 62,208 distinct byte triples drawn
    from a seeded numpy generator; the loader puts the 256 specials at
    128000-128255."""
    import base64

    import numpy as np

    tokens = [bytes([b]) for b in range(256)]
    tokens += [bytes([a, b]) for a in range(256) for b in range(256)]
    triples = np.random.default_rng(seed).choice(1 << 24, size=CHAT_RANKS - len(tokens),
                                                 replace=False)
    tokens += [int(t).to_bytes(3, "big") for t in triples]
    path.write_text("\n".join(f"{base64.b64encode(t).decode()} {i}"
                              for i, t in enumerate(tokens)))


def chat_text(tokenizer, n_tokens: int, rng) -> str:
    """Words of 2-9 random lowercase letters, as many as encode to at least
    ``n_tokens`` ids."""
    words = []
    while len(tokenizer.encode(" ".join(words))) < n_tokens:
        words += ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(2, 10)))
                  for _ in range(8)]
    return " ".join(words)


def eager_chat(params, cfg, tokenizer, turns, ctx: int, sinks: int):
    """The JAX package's interpreter loop (its ``read_tokens``) as plain
    `forward` calls at int positions, greedy, written here as the session's
    reference: each turn's messages and the assistant header rendered with
    the Llama-3 template and prefilled at the session's position, then one
    token at a time until an end-of-turn id (carried into the next prefill)
    or the turn's limit, the cache rolled by ``(ctx - sinks) // 4`` when it
    fills. Returns the reply ids of each turn, the final position, the
    cache and the number of rolls."""
    import torch

    from metalchat_tpu_torch.cache import KVCache, roll_kv_cache
    from metalchat_tpu_torch.chat.interpreter import ChatTemplates
    from metalchat_tpu_torch.chat.template import render_template
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.text.tokenizer import TokenKind

    tpl = ChatTemplates.llama3()
    dev = params["final_norm"].device
    cache = KVCache.create(cfg, 1, ctx, dtype=params["final_norm"].dtype, device=dev)
    stop = set(tokenizer.specials.ids_with_kind(
        TokenKind.END_TEXT | TokenKind.END_TURN | TokenKind.END_MESSAGE))
    buffer = tokenizer.encode(tpl.begin_text, allow_special=True)
    pos, rolls, replies = 0, 0, []
    for messages, limit in turns:
        for role, text in messages:
            buffer += tokenizer.encode(render_template(tpl.message, {"role": role,
                                                                     "content": text}),
                                       allow_special=True)
        buffer += tokenizer.encode(render_template(tpl.header, {"role": "assistant"}),
                                   allow_special=True)
        logits, _ = forward(params, cache, torch.tensor([buffer], device=dev), pos, cfg)
        pos, buffer, ids = pos + len(buffer), [], []
        while True:
            tok = int(logits[0, -1].argmax())
            if pos + 1 >= ctx:
                shift = max(1, (ctx - sinks) // 4)
                roll_kv_cache(cache, sinks, shift)
                pos, rolls = pos - shift, rolls + 1
            if tok in stop or len(ids) == limit:
                buffer += [tok] if tok in stop else []
                break
            ids.append(tok)
            logits, _ = forward(params, cache, torch.tensor([[tok]], device=dev), pos, cfg)
            pos += 1
        replies.append(ids)
    return replies, pos, cache, rolls


def chat_launches(counts, cfg, turns, per_step: dict):
    """The launches ``turns`` (a session's `TurnStats`) imply: ``per_step``
    each decode step, flash once a layer a prefill of more than 16 tokens,
    every other kernel never."""
    steps = sum(t.decode_steps for t in turns)
    want = dict.fromkeys(counts, 0)
    want.update({k: n * steps for k, n in per_step.items()})
    want["flash_attention"] = cfg.num_layers * sum(t.prefill_tokens > 16 for t in turns)
    return want


def turn_report(turns) -> str:
    return "; ".join(
        f"turn {i + 1}: prefill {t.prefill_tokens} at {t.start_pos}, TTFT "
        f"{1e3 * t.ttft_s:.2f} ms, {t.decode_steps} tokens at {t.decode_tok_s or 0:.2f} "
        f"tok/s, {t.rolls} roll(s)" for i, t in enumerate(turns))


def phase_chat(sm: Smoke, main):
    """The chat `Interpreter` at full width: phase main's 8b-w4a8 params, a
    Llama-3-layout tokenizer of 128,000 ranks (`write_llama3_tokenizer`),
    the Llama-3 template, greedy, a dense bf16 cache of 1024 positions, 4
    sinks. Turn 1: a system and a user message (about 600 tokens) and a
    reply of up to 64 tokens; turn 2: a user message of about 300 tokens
    prefilled by flash at the session's position, its reply of up to 128
    tokens crossing position 1023, so the cache rolls. The session captures
    one decode step for both turns; ids, pos and cache equal `eager_chat`'s
    bit for bit; launches exact (row 1 and row 5 each step, flash each
    prefill)."""
    torch = sm.torch
    import tempfile
    from pathlib import Path

    import numpy as np

    from metalchat_tpu_torch.chat.interpreter import ChatTemplates, Interpreter
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.sampling import SamplerConfig
    from metalchat_tpu_torch.text import load_tiktoken_model

    cfg, params = main[0], main[1]
    L = cfg.num_layers
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_llama3_tokenizer(Path(tmp) / "tokenizer.model")
        tok = load_tiktoken_model(Path(tmp) / "tokenizer.model")
    load_s = time.perf_counter() - t
    sm.expect(tok.vocab_size == cfg.vocab_size
              and tok.specials.id_of("<|begin_of_text|>") == 128000,
              f"chat: tokenizer vocab {tok.vocab_size}")
    rng = np.random.default_rng(1)
    turns = [(tuple((role, chat_text(tok, n, rng)) for role, n in msgs), limit)
             for msgs, limit in CHAT_TURNS]
    session = Interpreter(params, cfg, tok, templates=ChatTemplates.llama3(),
                          sampler=SamplerConfig.greedy(), max_seq_len=CHAT_CTX,
                          sink_tokens=CHAT_SINKS, max_reply_tokens=128)
    reset_launch_counts()
    got = []
    for messages, limit in turns:
        for role, text in messages:
            session.write(text, role=role)
        session.scanner.scanners[1].limit = limit  # the turn's reply limit
        got.append(list(session.read_tokens()))
    counts = launch_counts()
    t = time.perf_counter()
    want, pos, cache, rolls = eager_chat(params, cfg, tok, turns, CHAT_CTX, CHAT_SINKS)
    eager_s = time.perf_counter() - t
    expected = chat_launches(counts, cfg, session.turns,
                             {"a8_matvec": 4 * L + 1, "a8_quantize": 4 * L + 1,
                              "decode_attention": L})
    print(f"chat 8b-w4a8 (tokenizer of {tok.vocab_size} ids made and loaded in {load_s:.1f} "
          f"s; dense bf16 cache {CHAT_CTX}, {CHAT_SINKS} sinks): "
          f"{turn_report(session.turns)}; captures {session.captures}; eager loop "
          f"{eager_s:.2f} s; ids equal: {got == want}; launches {counts}", flush=True)
    sm.expect(got == want, "chat: the session's ids differ from the eager loop's")
    sm.expect(session.pos == pos, f"chat: pos {session.pos} != the eager loop's {pos}")
    for name in ("k", "v"):
        sm.exact(getattr(session.cache, name), getattr(cache, name),
                 f"chat: cache {name}, the session against the eager loop")
    sm.expect(session.captures == 1, f"chat: {session.captures} captures in one session")
    sm.expect(rolls >= 1 and sum(t.rolls for t in session.turns) == rolls,
              f"chat: {rolls} rolls")
    t2 = session.turns[1]
    sm.expect(t2.start_pos > 0 and t2.prefill_tokens > 16, f"chat: turn 2 {t2}")
    sm.expect(counts == expected, f"chat: launches {counts} != expected {expected}")
    return counts


@contextlib.contextmanager
def cli_home():
    """A temporary METALCHAT_TPU_HOME and working directory, both removed
    afterwards; yields the directory."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix="metalchat_cli_"))
    old = os.environ.get("METALCHAT_TPU_HOME")
    os.environ["METALCHAT_TPU_HOME"] = str(tmp / "home")
    try:
        with contextlib.chdir(tmp):
            yield tmp
    finally:
        if old is None:
            os.environ.pop("METALCHAT_TPU_HOME", None)
        else:
            os.environ["METALCHAT_TPU_HOME"] = old
        shutil.rmtree(tmp, ignore_errors=True)


def run_cli(argv):
    """The CLI's `main` in this process: (stdout, stderr, sessions with the
    seconds each took to load). Fails on a non-zero exit."""
    import io

    from metalchat_tpu_torch.cli import main as cli

    out, err, sessions = io.StringIO(), io.StringIO(), []
    load = cli._load_session

    def timed_load(ref, args):
        t = time.perf_counter()
        session = load(ref, args)
        sessions.append((session, time.perf_counter() - t))
        return session

    cli._load_session = timed_load
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([str(a) for a in argv])
    finally:
        cli._load_session = load
    if rc != 0:
        raise AssertionError(f"CLI {argv} exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), sessions


@contextlib.contextmanager
def recorded_replies():
    """Records the ids of CLI replies made in this process: ``greedy`` the
    chat session's (`Interpreter.read_tokens`), ``prompt`` and
    ``speculative`` the rendered prompt and ids of `speculative_generate`."""
    import importlib

    interp = importlib.import_module("metalchat_tpu_torch.chat.interpreter")
    spec = importlib.import_module("metalchat_tpu_torch.engine.speculative")
    read_tokens, spec_generate = interp.Interpreter.read_tokens, spec.speculative_generate
    ids = {"greedy": []}

    def reading(self):
        for t in read_tokens(self):
            ids["greedy"].append(t)
            yield t

    def speculating(*args, **kwargs):
        out, stats = spec_generate(*args, **kwargs)
        ids["prompt"], ids["speculative"] = args[4], out.tolist()
        return out, stats

    interp.Interpreter.read_tokens, spec.speculative_generate = reading, speculating
    try:
        yield ids
    finally:
        interp.Interpreter.read_tokens, spec.speculative_generate = read_tokens, spec_generate


def greedy_manifest(ref: str) -> None:
    """[inference.sampling] temperature = 0 in a stored model's manifest."""
    from metalchat_tpu_torch.cli.store import Manifest, ModelStore

    model = ModelStore().find(ref)
    manifest = Manifest.load(model.path / Manifest.FILENAME)
    manifest.inference["sampling"] = {"temperature": 0}
    manifest.save(model.path / Manifest.FILENAME)


def phase_cli_fixture(sm: Smoke):
    """The CLI on the trained fixture: ``model pull`` into a temporary home;
    ``serve`` (JSONL, 2 slots, dense bf16) of tests/test_fixture_e2e.py's
    PROMPT at temperature 0, its first 16 ids against the library path on
    the CPU in bf16 (`generate`), printed beside GOLDEN (f32); ``prompt
    --quantize int4`` with a greedy manifest (row 11 each decode step);
    ``prompt --draft`` with the checkout as its own draft (the step-ratio
    check, then speculative decoding at n_draft 4): its reply equal to the
    greedy ``prompt`` reply, or parting from it at a near tie (`near_tie`:
    bf16 logits of a verify window and of a one-token step may round apart);
    ``checkout`` as a process of its own with two lines on stdin. Launches
    exact in each but ``--draft``: the engine's own counters (its summary on
    stderr) for serve, the session's turns for prompt and checkout."""
    torch = sm.torch
    import ast
    import os
    from pathlib import Path

    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    root = Path(__file__).resolve().parent
    fixture = root / "tests" / "fixtures" / "pyllama_10m"
    cfg = load_config(fixture / "config.json")
    L = cfg.num_layers
    out = {}
    with cli_home() as tmp:
        run_cli(["model", "pull", fixture, "--name", "pyllama"])
        greedy_manifest("pyllama")

        reqs = tmp / "reqs.jsonl"
        reqs.write_text(json.dumps({"prompt": FIXTURE_PROMPT, "max_tokens": 24,
                                    "temperature": 0.0}) + "\n")
        reset_launch_counts()
        stdout, stderr, _ = run_cli(["serve", "pyllama", "--input", reqs, "--slots", 2,
                                     "--max-seq-len", 256])
        counts = launch_counts()
        line = json.loads(stdout.splitlines()[0])
        summary = ast.literal_eval(stderr.split("requests: ", 1)[1].strip())
        cpu = load_params(open_safetensors(fixture), cfg, dtype=torch.bfloat16,
                          max_seq_len=256, device="cpu")
        ref = generate(cpu, cfg, torch.tensor([list(FIXTURE_PROMPT.encode())]),
                       max_new_tokens=24)[0].tolist()
        got = list(line["text"].encode())
        want = dict.fromkeys(counts, 0)
        want.update(decode_attention=L * summary["decode_steps"],
                    flash_attention=L * summary["prefill_dispatches"])
        print(f"cli-fixture serve (bf16 dense, 2 slots): {line['tokens']} tokens "
              f"{line['finish_reason']}, ids {got}; CPU library path (bf16) {ref}; GOLDEN "
              f"(f32) {FIXTURE_GOLDEN[:24]}; engine {summary}; launches {counts}", flush=True)
        sm.expect(got[:16] == ref[:16], "cli-fixture serve: the first 16 ids differ from "
                  "the CPU library path's")
        sm.expect(summary["combined_dispatches"] == 0 and counts == want,
                  f"cli-fixture serve: launches {counts} != expected {want}")
        out["serve"] = counts

        reset_launch_counts()
        content = "Write a Python function that reads a file and counts its lines."
        stdout, _, sessions = run_cli(["prompt", "pyllama", "-c", content, "--quantize",
                                       "int4", "--max-tokens", 32])
        counts = launch_counts()
        session, load_s = sessions[0]
        want = chat_launches(counts, cfg, session.turns,
                             {"quant_matmul": 7 * L, "decode_attention": L})
        print(f"cli-fixture prompt --quantize int4: {stdout!r}; load {load_s:.2f} s; "
              f"{turn_report(session.turns)}; launches {counts}", flush=True)
        sm.expect(session.turns[0].prefill_tokens > 32 and session.turns[0].decode_steps > 0,
                  f"cli-fixture prompt: {session.turns}")
        sm.expect(counts == want, f"cli-fixture prompt: launches {counts} != expected {want}")
        out["int4"] = counts

        with recorded_replies() as ids:
            greedy, _, _ = run_cli(["prompt", "pyllama", "-c", content, "--max-tokens", 32])
            reset_launch_counts()
            stdout, stderr, sessions = run_cli(
                ["prompt", "pyllama", "-c", content, "--max-tokens", 32, "--draft", "pyllama",
                 "--n-draft", SPEC_DRAFT])
            counts = launch_counts()
        target = sessions[0][0]
        drafted = [t for t in ids["speculative"] if t not in target.stop_ids]
        verdict = "identical" if stdout == greedy else near_tie(
            sm, "cli-fixture prompt --draft", target.params, target.config,
            ids["prompt"].cuda(), ids["greedy"], drafted)
        notes = [line for line in stderr.splitlines() if line.startswith("[speculative]")]
        print(f"cli-fixture prompt --draft (the checkout as its own draft, n_draft "
              f"{SPEC_DRAFT}, bf16): {stdout!r}; against the greedy prompt's reply: "
              f"{verdict}; {notes}; launches {counts}", flush=True)
        sm.expect((stdout == greedy) == (drafted == ids["greedy"]),
                  f"cli-fixture prompt --draft: ids {drafted} and {ids['greedy']}")
        sm.expect(len(notes) == 2 and "accept_rate=" in notes[1]
                  and counts["decode_attention"] > 0 and counts["flash_attention"] > 0,
                  f"cli-fixture prompt --draft: {notes}, launches {counts}")
        out["draft"] = counts

        proc = subprocess.run(
            [sys.executable, "-c", CHECKOUT_DRIVER, "checkout", "pyllama", "--max-tokens", "16"],
            input="def add(a, b):\nprint('hello')\n", capture_output=True, text=True,
            timeout=600, cwd=tmp, env={**os.environ, "PYTHONPATH": str(root)})
        sm.expect(proc.returncode == 0, f"cli-fixture checkout exited {proc.returncode}: "
                  f"{proc.stderr[-3000:]}")
        report = json.loads(proc.stderr.strip().splitlines()[-1])
        turns = [type(session.turns[0])(**t) for t in report["turns"]]
        counts = report["launches"]
        want = chat_launches(counts, cfg, turns, {"decode_attention": L})
        print(f"cli-fixture checkout (a process of its own): stdout {proc.stdout!r}; "
              f"{turn_report(turns)}; captures {report['captures']}; launches {counts}",
              flush=True)
        sm.expect(len(turns) == 2 and all(t.decode_steps > 0 for t in turns)
                  and proc.stdout.count(">>> ") == 3, "cli-fixture checkout: not two replies")
        sm.expect(report["captures"] == 1, f"cli-fixture checkout: {report['captures']} "
                  "captures in one session")
        sm.expect(counts == want, f"cli-fixture checkout: launches {counts} != {want}")
        out["checkout"] = counts
    return out


@contextlib.contextmanager
def load_split(torch):
    """Times the CLI's model load by part, on the host clock, each part
    ending in ``synchronize``: "mmap and header" (the repository's
    `open_safetensors`: the native mapping, the header parse, WILLNEED),
    "host reads and stacking" (`load_params` on the CPU: each tensor read
    from the mapping, cast and stacked), "upload" (the stacked tree copied
    to the card, the rope tables made there as `load_params` makes them)
    and "quantize" (`quantize_params` on the card). The tree is the one
    `load_params` builds on the card. Yields the dict of seconds."""
    import importlib

    repo_mod = importlib.import_module("metalchat_tpu_torch.io.repository")
    loaders = importlib.import_module("metalchat_tpu_torch.io.loaders")
    quant = importlib.import_module("metalchat_tpu_torch.quant.quantize")
    split = {}
    retrieve, load, quantize = (repo_mod.FilesystemRepository.retrieve_weights,
                                loaders.load_params, quant.quantize_params)

    def timed_retrieve(self):
        t = time.perf_counter()
        doc = retrieve(self)
        split["mmap and header"] = time.perf_counter() - t
        return doc

    def timed_load(doc, config, *, dtype=torch.bfloat16, device=None, **kw):
        t = time.perf_counter()
        host = load(doc, config, dtype=dtype, device="cpu", **kw)
        split["host reads and stacking"] = time.perf_counter() - t
        t = time.perf_counter()
        card = to_device({k: v for k, v in host.items() if k != "rope"}, device)
        card["rope"] = loaders.make_rope_tables(config, kw.get("max_seq_len"), device=device)
        torch.cuda.synchronize()
        split["upload"] = time.perf_counter() - t
        return card

    def timed_quantize(params, **kw):
        t = time.perf_counter()
        out = quantize(params, **kw)
        torch.cuda.synchronize()
        split["quantize"] = time.perf_counter() - t
        return out

    repo_mod.FilesystemRepository.retrieve_weights = timed_retrieve
    loaders.load_params, quant.quantize_params = timed_load, timed_quantize
    try:
        yield split
    finally:
        repo_mod.FilesystemRepository.retrieve_weights = retrieve
        loaders.load_params, quant.quantize_params = load, quantize


def phase_cli_1b(sm: Smoke):
    """The CLI at Llama-3.2-1B's published widths: a checkout written here
    (its config.json, random bf16 weights from a seeded torch.Generator
    through `save_params` + `save_safetensors`, the chat phase's tokenizer
    layout), ``model pull``, then ``prompt --quantize w8a8 --max-tokens 64``
    with a greedy manifest: row 1 (bits 8) each decode step for the seven
    linears of each layer, row 5 at hd 64, flash for the prompt. Prints the
    time to load and quantize (and its parts, `load_split`), to tokenize the
    message, the TTFT and the decode tok/s; launches exact. The checkout
    opens through the native mapping and the message encodes through the
    native merge loop (`native.CALLS`), its ids equal to the Python merge's
    (`encode_piece_plain`). The checkout is deleted afterwards."""
    torch = sm.torch
    import copy

    import numpy as np

    from metalchat_tpu_torch import native
    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import save_params
    from metalchat_tpu_torch.io.safetensors import save_safetensors
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.text import load_tiktoken_model

    with cli_home() as tmp:
        ckpt = tmp / "Llama-3.2-1B"
        ckpt.mkdir()
        (ckpt / "config.json").write_text(json.dumps(LLAMA32_1B_CONFIG))
        cfg = load_config(ckpt / "config.json")
        L = cfg.num_layers
        t = time.perf_counter()
        params = init_random_params(cfg, seed=0, dtype=torch.bfloat16, max_seq_len=16,
                                    device="cuda")
        save_safetensors(ckpt / "model.safetensors", save_params(params, cfg))
        del params
        torch.cuda.empty_cache()
        write_llama3_tokenizer(ckpt / "tokenizer.model")
        write_s = time.perf_counter() - t
        size = (ckpt / "model.safetensors").stat().st_size
        run_cli(["model", "pull", ckpt, "--name", "llama-3.2-1b"])
        greedy_manifest("llama-3.2-1b")

        reset_launch_counts()
        native.reset_calls()
        tokenizer_s = time.perf_counter()
        tok = load_tiktoken_model(ckpt / "tokenizer.model")
        tokenizer_s = time.perf_counter() - tokenizer_s
        content = chat_text(tok, 200, np.random.default_rng(2))
        t = time.perf_counter()
        ids = tok.encode(content, allow_special=True)
        encode_s = time.perf_counter() - t
        n_ids, pieces = len(ids), native.CALLS["encode_piece"]
        plain = copy.copy(tok)
        plain._native = None  # the Python merge loop alone
        t = time.perf_counter()
        plain_ids = plain.encode(content, allow_special=True)
        plain_s = time.perf_counter() - t
        sm.expect(ids == plain_ids, "cli-1b: the native merge's ids differ from the Python "
                  "merge's")
        sm.expect(pieces > 0 and native.CALLS["encode_piece"] == pieces,
                  f"cli-1b: native encode calls {native.CALLS}")
        with load_split(torch) as split:
            stdout, _, sessions = run_cli(["prompt", "llama-3.2-1b", "-c", content,
                                           "--quantize", "w8a8", "--max-tokens", 64])
        counts = launch_counts()
        sm.expect(native.CALLS["mmap_open"] >= 1 and native.CALLS["encode_piece"] > pieces,
                  f"cli-1b: the checkout did not open through the native mapping or the "
                  f"session did not encode natively: {native.CALLS}")
        sm.expect(set(split) == {"mmap and header", "host reads and stacking", "upload",
                                 "quantize"}, f"cli-1b: load split {split}")
        session, load_s = sessions[0]
        turn = session.turns[0]
        want = chat_launches(counts, cfg, session.turns,
                             {"a8_matvec": 7 * L, "a8_quantize": 7 * L, "decode_attention": L})
        print(f"cli 1b-w8a8 (Llama-3.2-1B widths, checkout {size / 1e9:.3f} GB written in "
              f"{write_s:.1f} s): load and quantize {load_s:.2f} s ("
              + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
              + f"; the rest {load_s - sum(split.values()):.3f} s; its tokenizer load "
              f"{tokenizer_s:.2f} s alone); tokenize the {n_ids}-token message "
              f"{1e3 * encode_s:.2f} ms through the native merge ({pieces} pieces; the "
              f"Python merge {1e3 * plain_s:.2f} ms, ids equal); native calls "
              f"{native.CALLS}; TTFT {1e3 * turn.ttft_s:.2f} ms (prefill "
              f"{turn.prefill_tokens} tokens); {turn.decode_steps} tokens at "
              f"{turn.decode_tok_s or 0:.2f} tok/s; cache {session.cache.max_seq_len} "
              f"positions; {len(stdout)} characters out; launches {counts}", flush=True)
        sm.expect(turn.decode_steps > 0 and turn.prefill_tokens > 16, f"cli-1b: {turn}")
        sm.expect(counts == want, f"cli-1b: launches {counts} != expected {want}")
        return counts


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_window(torch, name: str, fn) -> None:
    """torch.profiler over ``fn()``: the device's busy share of the host's
    wall time and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Device events but the ranges of `record_function` annotations (the
    # engine's "prefill" / "decode burst"), which span whole calls.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"  profile {name}: device busy share not measured "
              "(the profiler recorded no device activity)")
        return
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        key = next((k for k in ("a8_matvec", "a8_mma", "a8_quantize", "decode_kernel",
                                "flash", "paged_kernel", "qmm_", "ffn_block") if k in e.name),
                   e.name[:48])
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:7]
    print(f"  profile {name}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({busy / wall_us:.4f} of wall), {len(kernels)} "
          "kernels; device ms by kernel: "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top))


def phase_profile(sm: Smoke, main, label: str = "8b-w4a8", ffn_block: bool = False,
                  prefill: bool = True):
    """Where a generate run's time goes: torch.profiler over one 512-token
    prefill, 8 eager decode steps (`forward` calls) and 8 replays of the
    captured decode step (`make_decode_step`) of the 8B model: the device's
    busy share of the host's wall time and device time by kernel."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import make_decode_step, make_prefill
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.sampling import SamplerConfig

    cfg, params, _, _, _, prompt = main
    dev = torch.device("cuda")
    cache = QuantizedKVCache.create(cfg, 1, 1024, device=dev)
    s = prompt.shape[1]
    step = lambda: forward(params, cache, prompt, 0, cfg)  # noqa: E731
    if prefill:
        profile_window(torch, f"{label} prefill", step)
    else:
        step()
    profile_window(torch, f"{label} decode x8", lambda: [
        forward(params, cache, prompt[:, i:i + 1], s + i, cfg, ffn_block=ffn_block)
        for i in range(8)])
    greedy = SamplerConfig.greedy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = make_prefill(cfg, greedy, (), ffn_block)(
        params, QuantizedKVCache.create(cfg, 1, 1024, device=dev), prompt, 0, gen)
    replayed = make_decode_step(cfg, greedy, (), ffn_block)
    for _ in range(2):  # the warm-up step and capture, then one replay
        replayed.advance(params, state)
    profile_window(torch, f"{label} replayed decode x8",
                   lambda: [replayed.advance(params, state) for _ in range(8)])


def a8_calls(torch, cfg, params, rows: int, gen):
    """One decode step's matvec calls at ``rows`` rows: (name, packed
    weights, scales, input, norm stack or None, calls a step)."""
    dev = torch.device("cuda")
    layers, lm, L = params["layers"], params["lm_head"], cfg.num_layers
    x = torch.randn((rows, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    x2 = torch.randn((rows, cfg.intermediate_size), generator=gen, device=dev).to(torch.bfloat16)
    return [("wqkv", layers["wqkv"].q, layers["wqkv"].scales, x, layers["attn_norm"], L),
            ("wo", layers["wo"].q, layers["wo"].scales, x, None, L),
            ("w13", layers["w13"].q, layers["w13"].scales, x, layers["ffn_norm"], L),
            ("w2", layers["w2"].q, layers["w2"].scales, x2, None, L),
            ("lm_head", lm.q[None], lm.scales[None], x, None, 1)]


def a8_bound(pq, norm, rows: int, rate: float):
    """Least time of one fused matvec call: the packed weights and scales
    read once, the bf16 rows in and out (and the norm weights)."""
    _, out_f, k = pq.shape
    in_f = 2 * k
    nbytes = (out_f * k + out_f * 2 + rows * (in_f + out_f) * 2
              + (in_f * 2 if norm is not None else 0))
    return bound(nbytes, 2 * rows * in_f * out_f, "int8", rate)


def phase_timing(sm: Smoke, main, rate: float):
    """Each kernel at the main path's shapes: kernel (CUDA graph replay),
    plain version (eager), one library call (graph), and the bound."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from metalchat_tpu_torch.ops.quant_matmul import unpack_int4

    cfg, params, cache, counts, length, _ = main
    dev = torch.device("cuda")
    L = cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []

    # a8_matvec: one decode step's calls (4 per layer + lm_head).
    a8 = a8_calls(torch, cfg, params, 1, gen)
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    raw_step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for name, pq, ps, xin, norm, per_step in a8:
        n_layers, out_f, k = pq.shape
        in_f = 2 * k
        kw = dict(bits=4) if norm is None else dict(
            bits=4, norm_stack=norm, norm_eps=cfg.rms_norm_eps)
        ms = sm.device_ms(lambda i: am.quant_matvec_stacked_fused(
            xin, pq, ps, i % n_layers, **kw), 64)
        plain = sm.eager_ms(lambda i: am.quant_matvec_stacked_fused_plain(
            xin, pq, ps, i % n_layers, **kw), 3)
        # Library yardstick: cuBLAS int8 GEMM on the unpacked int8 weights at
        # its smallest row count (17); enough layers to exceed the L2 cache.
        n_lib = max(1, min(n_layers, math.ceil(120e6 / (out_f * in_f))))
        unpacked = [unpack_int4(pq[i], -1).contiguous() for i in range(n_lib)]
        xq17 = torch.randint(-127, 128, (17, in_f), generator=gen, device=dev,
                             dtype=torch.int8)
        lib = sm.device_ms(lambda i: torch._int_mm(xq17, unpacked[i % n_lib].t()), 32)
        sm.a8_library[name] = lib
        del unpacked
        # Raw mode (int8 rows in, int32 out) at the same shapes.
        xq1 = xq17[:1]
        raw_ms = sm.device_ms(lambda i: am.quant_matvec_stacked(
            xq1, pq, i % n_layers, bits=4), 64)
        raw_plain = sm.eager_ms(lambda i: am.quant_matvec_stacked_plain(
            xq1, pq, i % n_layers, bits=4), 3)
        raw_bound, _ = bound(out_f * k + in_f + out_f * 4, 2 * in_f * out_f, "int8", rate)
        for key, val in (("ms", raw_ms), ("plain_ms", raw_plain), ("bound_ms", raw_bound)):
            raw_step[key] += per_step * val
        b_ms, b_by = a8_bound(pq, norm, 1, rate)
        print(f"  a8_matvec {name} [{out_f}x{in_f} w4]: {ms * 1e3:.2f} us "
              f"(bound {b_ms * 1e3:.2f} us, {b_by}; plain {plain * 1e3:.1f} us; "
              f"_int_mm M=17 int8 {lib * 1e3:.2f} us; raw mode {raw_ms * 1e3:.2f} us) "
              f"x{per_step}/token")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b_ms)):
            step[key] += per_step * val
    print(f"  a8_matvec at one row, one decode step ({4 * L + 1} calls, each a8_quantize and "
          f"the tensor-core matvec): {step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms, "
          f"bytes; _int_mm M=17 {step['library_ms']:.4f} ms)")
    print(f"  a8_matvec raw mode (not on the main path), one decode step's {4 * L + 1} "
          f"shapes: {raw_step['ms']:.4f} ms (bound {raw_step['bound_ms']:.4f} ms, bytes; "
          f"plain {raw_step['plain_ms']:.3f} ms)")
    rows.append(dict(row=1, name="a8_matvec", source="metalchat_tpu_torch/csrc/a8_matvec.cu",
                     replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262",
                     bound_by="bytes", unit=f"one decode step ({4 * L + 1} calls)",
                     **step))
    rows.append(dict(row=2, name="a8_matvec_raw", counter="a8_matvec_raw",
                     source="metalchat_tpu_torch/csrc/a8_matvec.cu",
                     replaces="metalchat_tpu/ops/a8_matvec_pallas.py:187", bound_by="bytes",
                     library_ms=step["library_ms"], max_abs_err=0.0,
                     unit=f"one decode step's {4 * L + 1} shapes, int8 rows in, int32 out "
                          "(raw mode, on no driven path; library as row 1)", **raw_step))

    # decode_attention_update: one decode step (one call per layer) at the
    # main path's last length; first at lengths 64 and 1024, the kernel and
    # its yardstick only (the cache past the main path's length is zeros).
    q = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((1, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (cache.k, cache.v, cache.k_scale, cache.v_scale)

    def decode_update(n: int):
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        ms = sm.device_ms(lambda i: dm.decode_attention_update_quantized_stacked(
            q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 64)
        kd = dequantize_kv(cache.k[0, :, :, :n], cache.k_scale[0, :, :, :n])
        vd = dequantize_kv(cache.v[0, :, :, :n], cache.v_scale[0, :, :, :n])
        # Library yardstick: SDPA over the dequantized bf16 K/V of one layer,
        # its KV heads repeated to the query heads outside the timed call.
        kd, vd = (t.repeat_interleave(nh // nkv, dim=1) for t in (kd, vd))
        lib = sm.device_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd), 64)
        nbytes = (2 * nkv * n * (hd + 4) + 2 * nh * hd * 2 + 2 * nkv * hd * 2
                  + 2 * nkv * (hd + 4))
        return (ms, lib, *bound(nbytes, 4 * nh * hd * n, "f32", rate), lens)

    for n in (64, 1024):
        ms, lib, b_ms, b_by, _ = decode_update(n)
        print(f"  decode_attention_update [length {n}, T {cache.k.shape[3]}]: "
              f"{ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}; sdpa bf16 "
              f"{lib * 1e3:.2f} us) x{L}/token: {L * ms:.5f} ms a step, sdpa "
              f"{L * lib:.5f}")
    ms, lib, b_ms, b_by, lens = decode_update(length)
    plain = sm.eager_ms(lambda i: dm.decode_attention_update_plain(
        q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 5)
    print(f"  decode_attention_update [length {length}, T {cache.k.shape[3]}]: "
          f"{ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}; plain "
          f"{plain * 1e3:.1f} us; sdpa bf16 {lib * 1e3:.2f} us) x{L}/token")
    rows.append(dict(row=3, name="decode_attention_update",
                     source="metalchat_tpu_torch/csrc/decode_attention.cu",
                     replaces="metalchat_tpu/ops/decode_attention_pallas.py:598",
                     ms=L * ms, plain_ms=L * plain, library_ms=L * lib,
                     bound_ms=L * b_ms, bound_by=b_by,
                     unit=f"one decode step ({L} calls, length {length})"))

    # flash_attention at hd=64 (the fixture's and Llama-3.2-1B's head size),
    # 32 heads over 8 kv heads, random bf16, a 512-token prefill from 0:
    # the kernel and its yardstick only.
    S = 512
    q64, k64, v64 = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for shape in ((1, S, nh, 64), (1, nkv, S, 64), (1, nkv, S, 64)))
    ms64 = sm.device_ms(lambda i: flash_attention(q64, k64, v64, 0, scale=0.125), 8)
    k64, v64 = (t.repeat_interleave(nh // nkv, dim=1) for t in (k64, v64))
    lib64 = sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q64.transpose(1, 2), k64, v64, is_causal=True), 8)
    b64, by64 = bound(2 * (2 * S * nh * 64 + 2 * nkv * S * 64),
                      4 * 64 * nh * S * (S + 1) / 2, "bf16", rate)
    print(f"  flash_attention hd=64 [S {S}, kv {S}, {nh} heads]: {ms64 * 1e3:.1f} us "
          f"(bound {b64 * 1e3:.2f} us, {by64}; sdpa causal {lib64 * 1e3:.1f} us): "
          f"{L * ms64:.5f} ms for {L} calls, sdpa {L * lib64:.5f}")
    del q64, k64, v64

    # flash_attention: one 512-token prefill (one call per layer).
    qf = torch.randn((1, S, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kf = dequantize_kv(cache.k[0, :, :, :S], cache.k_scale[0, :, :, :S])
    vf = dequantize_kv(cache.v[0, :, :, :S], cache.v_scale[0, :, :, :S])
    ms = sm.device_ms(lambda i: flash_attention(qf, kf, vf, 0, scale=hd ** -0.5), 8)
    plain = sm.eager_ms(lambda i: flash_attention_plain(qf, kf, vf, 0,
                                                           scale=hd ** -0.5), 3)
    qt = qf.transpose(1, 2)
    kr, vr = (t.repeat_interleave(nh // nkv, dim=1) for t in (kf, vf))
    lib = sm.device_ms(lambda i: F.scaled_dot_product_attention(
        qt, kr, vr, is_causal=True), 8)
    nbytes = 2 * (2 * S * nh * hd + 2 * nkv * S * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * nh * S * (S + 1) / 2, "bf16", rate)
    print(f"  flash_attention [S {S}, kv {S}]: {ms * 1e3:.1f} us (bound "
          f"{b_ms * 1e3:.2f} us, {b_by}; plain {plain * 1e3:.1f} us; sdpa causal "
          f"{lib * 1e3:.1f} us) x{L}/prefill")
    rows.append(dict(row=4, name="flash_attention",
                     source="metalchat_tpu_torch/csrc/flash_attention.cu",
                     replaces="metalchat_tpu/ops/flash_attention_pallas.py:136",
                     ms=L * ms, plain_ms=L * plain, library_ms=L * lib,
                     bound_ms=L * b_ms, bound_by=b_by,
                     unit=f"one {S}-token prefill ({L} calls)"))
    for r in rows:
        counter = r.get("counter", r["name"])
        r.setdefault("max_abs_err", sm.err.get(counter))
        r.update(route="cuda", launches=counts[counter])
    return rows


SERVE_ROWS = {"paged_decode_attention_update": 8, "paged_decode_attention_stacked": 9,
              "decode_attention": 5}


def time_a8_serve(sm: Smoke, cfg, params, one_row, counts, rate: float):
    """Rows 1 and 2 at the serve decode step's 8 rows, per matrix: the fused
    call (a8_quantize, then the tensor-core matvec), a8_quantize alone, the
    plain version, the bound, phase timing's yardstick (torch._int_mm at
    M=17 on unpacked int8 weights) and raw mode; then the step's totals at 2
    and 16 rows. ``one_row`` holds phase timing's rows 1 and 2 (one row, the
    generate path), which go into the unit."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import a8_matvec as am

    dev = torch.device("cuda")
    L, eps = cfg.num_layers, cfg.rms_norm_eps
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    steps = {}
    for rows in (8, 2, 16):
        step = dict.fromkeys(("ms", "quantize_ms", "bound_ms", "library_ms", "plain_ms",
                              "quantize_plain_ms", "quantize_bound_ms", "raw_ms",
                              "raw_plain_ms", "raw_bound_ms"), 0.0)
        for name, pq, ps, xin, norm, per_step in a8_calls(torch, cfg, params, rows, gen):
            n_layers, out_f, k = pq.shape
            in_f = 2 * k
            kw = dict(bits=4) if norm is None else dict(bits=4, norm_stack=norm, norm_eps=eps)
            qkw = {} if norm is None else dict(norm_eps=eps)
            nw = (lambda i: None) if norm is None else (lambda i: norm[i % n_layers])  # noqa: E731
            vals = dict(
                ms=sm.device_ms(lambda i: am.quant_matvec_stacked_fused(
                    xin, pq, ps, i % n_layers, **kw), 64),
                quantize_ms=sm.device_ms(lambda i: am.quantize_rows(xin, nw(i), **qkw), 64),
                bound_ms=a8_bound(pq, norm, rows, rate)[0], library_ms=sm.a8_library[name])
            if rows == 8:
                xq = torch.randint(-127, 128, (rows, in_f), generator=gen, device=dev,
                                   dtype=torch.int8)
                vals.update(
                    plain_ms=sm.eager_ms(lambda i: am.quant_matvec_stacked_fused_plain(
                        xin, pq, ps, i % n_layers, **kw), 3),
                    quantize_plain_ms=sm.eager_ms(
                        lambda i: am.quantize_rows_plain(xin, nw(i), **qkw), 3),
                    # x in, the norm weights, codes, sx and corr out
                    quantize_bound_ms=bound(rows * in_f * 3 + (0 if norm is None else 2 * in_f)
                                            + rows * 8, 0, "f32", rate)[0],
                    raw_ms=sm.device_ms(lambda i: am.quant_matvec_stacked(
                        xq, pq, i % n_layers, bits=4), 64),
                    raw_plain_ms=sm.eager_ms(lambda i: am.quant_matvec_stacked_plain(
                        xq, pq, i % n_layers, bits=4), 3),
                    raw_bound_ms=bound(out_f * k + rows * in_f + rows * out_f * 4,
                                       2 * rows * in_f * out_f, "int8", rate)[0])
                print(f"  a8_matvec {name} [{out_f}x{in_f} w4, {rows} rows]: "
                      f"{vals['ms'] * 1e3:.2f} us (a8_quantize alone "
                      f"{vals['quantize_ms'] * 1e3:.2f} us; bound {vals['bound_ms'] * 1e3:.2f} "
                      f"us, bytes; plain {vals['plain_ms'] * 1e3:.1f} us; _int_mm M=17 int8 "
                      f"{vals['library_ms'] * 1e3:.2f} us); raw mode {vals['raw_ms'] * 1e3:.2f} "
                      f"us (bound {vals['raw_bound_ms'] * 1e3:.2f} us) x{per_step}/step")
            for key, val in vals.items():
                step[key] += per_step * val
        steps[rows] = step
        print(f"  a8_matvec at {rows} rows, one serve decode step ({4 * L + 1} calls): "
              f"{step['ms']:.4f} ms, a8_quantize alone {step['quantize_ms']:.4f} ms (bound "
              f"{step['bound_ms']:.4f} ms, bytes; _int_mm M=17 {step['library_ms']:.4f} ms)")
    s8 = steps[8]
    at = {r: f"{steps[r]['ms']:.4f} ms (bound {steps[r]['bound_ms']:.4f})" for r in (2, 16)}

    def at_one(r):
        return (f"at 1 row (generate) {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, launches {r['launches']}")

    common = dict(source="metalchat_tpu_torch/csrc/a8_matvec.cu", route="cuda", bound_by="bytes")
    return [
        dict(common, row=1, name="a8_matvec", counter="a8_matvec",
             replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262", ms=s8["ms"],
             plain_ms=s8["plain_ms"], bound_ms=s8["bound_ms"], library_ms=s8["library_ms"],
             max_abs_err=sm.err["a8_matvec"], launches=counts["a8_matvec"],
             unit=f"one serve decode step at 8 rows ({4 * L + 1} calls, each a8_quantize and "
                  f"the tensor-core matvec); 2 rows {at[2]}, 16 rows {at[16]}; "
                  + at_one(one_row[1])),
        dict(common, row=1, name="a8_quantize", counter="a8_quantize",
             replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262", ms=s8["quantize_ms"],
             plain_ms=s8["quantize_plain_ms"], bound_ms=s8["quantize_bound_ms"],
             library_ms=None, max_abs_err=sm.err["a8_quantize"], launches=counts["a8_quantize"],
             unit=f"the act-quant of row 1's {4 * L + 1} calls at 8 rows (inside row 1's "
                  "time); max_abs_err in int8 code quanta; library_ms null: no single "
                  "PyTorch call"),
        dict(common, row=2, name="a8_matvec_raw", counter="a8_matvec_raw",
             replaces="metalchat_tpu/ops/a8_matvec_pallas.py:187", ms=s8["raw_ms"],
             plain_ms=s8["raw_plain_ms"], bound_ms=s8["raw_bound_ms"],
             library_ms=s8["library_ms"], max_abs_err=0.0, launches=counts["a8_matvec_raw"],
             unit=f"one serve decode step's {4 * L + 1} shapes at 8 rows, int8 rows in, int32 "
                  "out (raw mode, on no driven path; library as row 1); " + at_one(one_row[2])),
    ]


def phase_timing_serve(sm: Smoke, main, serve, fixture_counts, one_row, rate: float):
    """The serve path's attention kernels at its shapes, one decode step
    (one call per layer) of 8 rows with lengths spread 128..1024. The paged
    kernel over the serve run's pool: write mode (row 8) and read-only on
    the stacked pool (row 9; row 7, its one-layer form, is timed in timing-mixtral).
    The dense kernel's read-only mode over a bf16 cache of 8 rows of 1024
    (row 5, the engine's default dense mode). Library yardstick: SDPA over
    the same K/V in bf16 (pages gathered and dequantized), heads repeated, a
    length mask. First the matvecs of one decode step (`time_a8_serve`)."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv, gather_page_scales, gather_pages_dense
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm

    cfg = main[0]
    engine = serve["paged"]["engine"]
    c = engine.cache
    Lp = c.k_pages.shape[0]  # the serve phase's depth (SERVE_LAYERS): pool layers cycled
    dev = torch.device("cuda")
    L, nh, nkv, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, mp, psize = c.page_table.shape[0], c.page_table.shape[1], c.page_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lengths = [(i + 1) * mp * psize // B for i in range(B)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = torch.randperm(B * mp, generator=gen, device=dev).to(torch.int32).reshape(B, mp)
    q = torch.randn((B, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    pool = (c.k_pages, c.v_pages, c.k_scale, c.v_scale)
    scale = hd ** -0.5
    visited = sum(lengths)
    # Bytes: the visited K/V rows and their scales, q in, out, the table and
    # lengths; write mode adds the new rows in and their codes and scales out.
    read_bytes = (visited * nkv * 2 * (hd + 4) + 2 * B * nh * hd * 2 + B * mp * 4 + B * 4)
    write_bytes = 2 * B * nkv * hd * 2 + 2 * B * nkv * (hd + 4)
    ops = 4 * nh * hd * visited

    kd = dequantize_kv(gather_pages_dense(c.k_pages[0], table), gather_page_scales(c.k_scale[0], table))
    vd = dequantize_kv(gather_pages_dense(c.v_pages[0], table), gather_page_scales(c.v_scale[0], table))
    kd, vd = (t.repeat_interleave(nh // nkv, dim=1) for t in (kd, vd))
    mask = (torch.arange(mp * psize, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib = L * sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask), 32)
    del kd, vd

    # Row 5: a bf16 cache [L, 8, n_kv, 1024, hd] of random values; bytes of
    # the visited rows (2 bytes an element, no scales), q in and out.
    T = mp * psize
    kc, vc = (torch.randn((L, B, nkv, T, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    dense_bytes = visited * nkv * 2 * hd * 2 + 2 * B * nh * hd * 2 + B * 4
    kr, vr = (t[0].repeat_interleave(nh // nkv, dim=1) for t in (kc, vc))
    lib_dense = L * sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], kr, vr, attn_mask=mask), 32)
    del kr, vr
    cases = [
        ("paged_decode_attention_update", "paged_decode_attention_update",
         "metalchat_tpu_torch/csrc/paged_attention.cu",
         "metalchat_tpu/ops/paged_attention_pallas.py:410", "write mode, paged",
         lambda i: pm.paged_decode_attention_update_stacked(
             q, kn, kn, *pool, table, lens, i % Lp, scale=scale),
         lambda i: pm.paged_decode_attention_update_plain(
             q, kn, kn, *pool, table, lens, i % Lp, scale=scale), read_bytes + write_bytes,
         lib, serve["paged"]["counts"]),
        ("paged_decode_attention_stacked", "paged_decode_attention",
         "metalchat_tpu_torch/csrc/paged_attention.cu",
         "metalchat_tpu/ops/paged_attention_pallas.py:491", "read-only, paged",
         lambda i: pm.paged_decode_attention_stacked(q, *pool, table, lens, i % Lp,
                                                     scale=scale),
         lambda i: pm.paged_decode_attention_plain(q, *pool, table, lens, i % Lp, scale=scale),
         read_bytes, lib, serve["paged"]["counts"]),
        ("decode_attention", "decode_attention",
         "metalchat_tpu_torch/csrc/decode_attention.cu",
         "metalchat_tpu/ops/decode_attention_pallas.py:323", "read-only, dense bf16 cache",
         lambda i: dm.decode_attention_stacked(q, kc, vc, i % L, lens, scale=scale),
         lambda i: dm.decode_attention_stacked_plain(q, kc, vc, None, None, i % L, lens,
                                                     scale=scale),
         dense_bytes, lib_dense, fixture_counts["dense-act"]),
    ]
    rows = time_a8_serve(sm, cfg, main[1], one_row, serve["paged"]["counts"], rate)
    for name, counter, source, replaces, mode, kernel, plain, nbytes, lib_ms, path in cases:
        ms = L * sm.device_ms(kernel, 64)
        plain_ms = L * sm.eager_ms(plain, 3)
        b_ms, b_by = bound(L * nbytes, L * ops, "f32", rate)
        print(f"  {name} [{mode}; 8 rows, lengths {lengths[0]}..{lengths[-1]}, T {T}]: "
              f"{ms:.4f} ms a step (bound {b_ms:.5f} ms, {b_by}; plain {plain_ms:.3f} ms; "
              f"sdpa bf16 {lib_ms:.4f} ms) for {L} calls")
        rows.append(dict(
            row=SERVE_ROWS[name], name=name, source=source, replaces=replaces, route="cuda",
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=sm.err[counter], launches=path[counter], counter=counter,
            unit=f"one decode step ({L} calls, 8 rows, lengths {lengths[0]}..{lengths[-1]})"))
    del kc, vc
    return rows


def qmm_leaf_times(sm: Smoke, name: str, leaf, xin, per_step: int, rate: float,
                   out_dtype=None) -> dict:
    """Row 11 on one (stacked) weight-only leaf at ``xin``'s rows, a call's
    ms: the kernel (CUDA graph replay over the layers), the plain version
    (eager), as the library yardstick one torch.matmul of x against the
    weights already dequantized to bf16, and the bound (packed weights, the
    group scales in their dtype, x in and out once; ``out_dtype`` f32 is
    the row-parallel mode, 4 bytes an output)."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import quant_matmul as qm

    rows = xin.shape[0]
    n = leaf.q.shape[0] if leaf.q.ndim == 3 else 1
    at = (lambda i: leaf.layer(i % n)) if leaf.q.ndim == 3 else (lambda i: leaf)
    kw = dict(bits=leaf.bits, group_size=leaf.group_size, transposed=leaf.transposed)
    ms = sm.device_ms(lambda i: qm.dequant_matmul(xin, at(i).q, at(i).scales,
                                                  out_dtype=out_dtype, **kw), 64)
    plain = sm.eager_ms(lambda i: qm.dequant_matmul_plain(xin, at(i).q, at(i).scales,
                                                          out_dtype=out_dtype, **kw), 3)
    one = at(0)
    n_lib = max(1, min(n, math.ceil(120e6 / (2 * one.in_features * one.out_features))))
    dense = [qm.dequant_weight(at(i).q, at(i).scales, dtype=torch.bfloat16, **kw)
             for i in range(n_lib)]
    lib = sm.device_ms(lambda i: torch.matmul(xin, dense[i % n_lib]), 32)
    del dense
    out_bytes = 2 if out_dtype is None else 4
    nbytes = (one.q.numel() + one.scales.numel() * one.scales.element_size()
              + rows * (2 * one.in_features + out_bytes * one.out_features))
    b_ms, b_by = bound(nbytes, 2 * rows * one.in_features * one.out_features, "bf16", rate)
    print(f"  quant_matmul {name} [{one.out_features}x{one.in_features} w{leaf.bits} "
          f"g{leaf.group_size} {'transposed' if leaf.transposed else 'natural'}, scales "
          f"{str(one.scales.dtype).removeprefix('torch.')}, {rows} row(s)"
          f"{', f32 out' if out_dtype is not None else ''}]: {ms * 1e3:.2f} us "
          f"(bound {b_ms * 1e3:.2f} us, {b_by}; plain {plain * 1e3:.1f} us; matmul on bf16 "
          f"weights {lib * 1e3:.2f} us) x{per_step}/token")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms)


def phase_timing_int4(sm: Smoke, run, rate: float):
    """Row 11 at 8b-int4's decode step, at 1 row (the generate path) and at
    8 rows: the 129 calls of one step, kernel (CUDA graph replay), plain
    version (eager), and as the library yardstick one torch.matmul of x
    against the weights already dequantized to bf16 (it leaves out the
    dequantization). Bound: the packed weights, the group scales, x in and
    out once."""
    torch = sm.torch
    cfg, params, counts = run[0], run[1], run[3]
    L = cfg.num_layers
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    layers, lm = params["layers"], params["lm_head"]
    steps = {}
    for rows in (1, 8):
        x = torch.randn((rows, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
        xf = torch.randn((rows, cfg.intermediate_size), generator=gen, device=dev).to(
            torch.bfloat16)
        step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for name, leaf, xin, per_step in (("wqkv", layers["wqkv"], x, L),
                                          ("wo", layers["wo"], x, L),
                                          ("w13", layers["w13"], x, L),
                                          ("w2", layers["w2"], xf, L), ("lm_head", lm, x, 1)):
            for key, val in qmm_leaf_times(sm, name, leaf, xin, per_step, rate).items():
                step[key] += per_step * val
        print(f"  quant_matmul at {rows} row(s), one 8b-int4 decode step ({4 * L + 1} calls): "
              f"{step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms; plain "
              f"{step['plain_ms']:.3f}; matmul on bf16 weights {step['library_ms']:.4f})")
        steps[rows] = step
    tp2 = qmm_tp2_step(sm, cfg, params, gen, rate)
    s8 = steps[8]
    return [dict(row=11, name="quant_matmul", source="metalchat_tpu_torch/csrc/quant_matmul.cu",
                 replaces="metalchat_tpu/ops/quant_matmul_pallas.py:145", route="cuda",
                 bound_by="bytes", launches=counts["quant_matmul"],
                 max_abs_err=sm.err["quant_matmul"],
                 unit=f"one 8b-int4 decode step ({4 * L + 1} calls, 1 row); library_ms is "
                      "torch.matmul on weights dequantized to bf16 beforehand; at 8 rows "
                      f"{s8['ms']:.4f} ms (bound {s8['bound_ms']:.4f}, plain "
                      f"{s8['plain_ms']:.3f}, library {s8['library_ms']:.4f}); a tp-2 rank's "
                      f"step at its local shapes (phase tp-leaves, 1 row) {tp2['ms']:.4f} ms "
                      f"(bound {tp2['bound_ms']:.4f}, plain {tp2['plain_ms']:.3f}, library "
                      f"{tp2['library_ms']:.4f})", **steps[1])]


def qmm_tp2_step(sm: Smoke, cfg, params, gen, rate: float) -> dict:
    """Row 11 at one row over a tp-2 rank's local 8b-int4 leaves (the
    shards `shard_params` gives rank 0; phase tp-leaves' one-token step):
    wqkv, w13 and the lm_head at half their outputs, wo and w2 at half
    their inputs in the f32-output mode (their partials are summed over
    ranks before they are rounded); the step's 129 calls summed."""
    torch = sm.torch
    from metalchat_tpu_torch.parallel import Mesh, shard_params

    L = cfg.num_layers
    local = shard_params(params, cfg, Mesh(tp=2, rank=0))
    layers, dev = local["layers"], torch.device("cuda")

    def x(n):
        return torch.randn((1, n), generator=gen, device=dev).to(torch.bfloat16)

    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    h, half_in = cfg.hidden_size, layers["wo"].in_features
    for name, leaf, xin, per_step, out_dtype in (
            ("wqkv tp2", layers["wqkv"], x(h), L, None),
            ("wo tp2", layers["wo"], x(half_in), L, torch.float32),
            ("w13 tp2", layers["w13"], x(h), L, None),
            ("w2 tp2", layers["w2"], x(layers["w2"].in_features), L, torch.float32),
            ("lm_head tp2", local["lm_head"], x(h), 1, None)):
        for key, val in qmm_leaf_times(sm, name, leaf, xin, per_step, rate, out_dtype).items():
            step[key] += per_step * val
    print(f"  quant_matmul at 1 row, a tp-2 rank's 8b-int4 step at its local shapes "
          f"({4 * L + 1} calls): {step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms; plain "
          f"{step['plain_ms']:.3f}; matmul on bf16 weights {step['library_ms']:.4f})")
    del local
    torch.cuda.empty_cache()
    return step


def phase_timing_ffn(sm: Smoke, main, ffn_run, rate: float):
    """Row 10 at 8b-w4a8's decode step, 1 and 8 rows: the kernel (one
    cooperative launch a layer) and the unmerged route of the same step (3
    a8_matvec launches and the glue a layer), both by CUDA graph replay, the
    plain version (eager), and the bound: wo,
    w13 and w2 packed bytes and scales, the norm weights, rows in and out.
    No single PyTorch call computes the block: library_ms is null."""
    torch = sm.torch
    from metalchat_tpu_torch.models.transformer import act_gate
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import ffn_block as fb

    cfg, params = main[0], main[1]
    L, H = cfg.num_layers, cfg.hidden_size
    eps = cfg.rms_norm_eps
    lay = params["layers"]
    wo, w13, w2, nw = lay["wo"], lay["w13"], lay["w2"], lay["ffn_norm"]
    args = (wo.q, wo.scales, nw, w13.q, w13.scales, w2.q, w2.scales)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = []
    for rows in (1, 8):
        attn, x = (torch.randn((rows, H), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2))

        def merged(i):
            return fb.ffn_block_stacked(attn, x, *args, i % L, bits=4, act="silu", eps=eps)

        def unmerged(i):
            l = i % L
            x2 = x + am.quant_matvec_stacked_fused(attn, wo.q, wo.scales, l, bits=4)
            g = act_gate(am.quant_matvec_stacked_fused(x2, w13.q, w13.scales, l, bits=4,
                                                        norm_stack=nw, norm_eps=eps))
            return x2 + am.quant_matvec_stacked_fused(g, w2.q, w2.scales, l, bits=4)

        ms = L * sm.device_ms(merged, 64)
        unmerged_ms = L * sm.device_ms(unmerged, 64)
        plain = L * sm.eager_ms(lambda i: fb.ffn_block_plain(
            attn, x, *args, i % L, bits=4, act="silu", eps=eps), 3)
        nbytes = sum(t[0].numel() * t.element_size() for t in args) + 2 * 2 * rows * H
        ops = 2 * rows * (wo.q.shape[1] * wo.in_features + w13.q.shape[1] * w13.in_features
                          + w2.q.shape[1] * w2.in_features)
        b_ms, b_by = bound(L * nbytes, L * ops, "int8", rate)
        print(f"  ffn_block [{rows} row(s), H {H}, F {cfg.intermediate_size}, w4]: "
              f"{ms:.4f} ms a step (bound {b_ms:.4f} ms, {b_by}; unmerged route "
              f"{unmerged_ms:.4f} ms; plain {plain:.3f} ms) for {L} launches")
        if rows == 1:
            out.append(dict(row=10, name="ffn_block", source="metalchat_tpu_torch/csrc/ffn_block.cu",
                            replaces="metalchat_tpu/ops/ffn_block_pallas.py:271", route="cuda",
                            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None, unmerged_ms=unmerged_ms,
                            launches=ffn_run[3]["ffn_block"], max_abs_err=sm.err["ffn_block"],
                            unit=f"one 8b-w4a8 decode step ({L} launches, 1 row); "
                                 "library_ms null: no single PyTorch call computes the block"))
        else:
            out[0]["unit"] += (f"; at {rows} rows {ms:.4f} ms (bound {b_ms:.4f}, unmerged "
                               f"{unmerged_ms:.4f}, plain {plain:.3f})")
    return out



def phase_timing_gemma(sm: Smoke, run, serve, rate: float):
    """Rows 3, 4, 5, 8 and 9 at hd 256, Gemma-3-1B's shapes, each layer with
    its own window (22 of 26 layers slide over 512 positions, 4 are
    global): one decode step of `generate` (row 3, one row at the phase's
    last length), one 640-token prefill (row 4), and one decode step of 8
    rows at lengths spread to 1024 over the serve-gemma engine's pool (row
    8, write mode; row 9, read-only) and over a bf16 dense cache (row 5,
    read-only). Kernel by
    CUDA graph replay over every layer, plain version eager, the bound from
    the positions each layer's window visits, and SDPA on bf16 K/V over the
    same positions (a mask for the window) as the library yardstick."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv, gather_page_scales, gather_pages_dense
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    cfg, params, cache, counts, length, _ = run
    dev = torch.device("cuda")
    L, nh, nkv, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    groups = nh // nkv
    windows = [cfg.layer_window(l) for l in range(L)]
    n_global = windows.count(-1)
    scale = cfg.attention_scale()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []

    def per_layer(fn, plain):
        """(kernel ms, plain ms) of one call on every layer."""
        return (L * sm.device_ms(fn, 2 * L), L * sm.eager_ms(plain, L))

    def visited(n, w):
        return n if w < 0 else min(n, w)

    def sdpa_rows(q, kd, vd, lens, w):
        """SDPA of one row a query over kd/vd [B, nh, T, hd] at lens [B],
        positions [lens - w, lens) (all below lens when w < 0)."""
        t = torch.arange(kd.shape[2], device=dev)[None, :]
        ok = t < lens[:, None]
        if w >= 0:
            ok &= t >= lens[:, None] - w
        return sm.device_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=ok[:, None, None, :]), 32)

    def library(fn_by_window):
        return sum(fn_by_window(w) for w in windows)

    # Row 3: generate's decode step, one row at the phase's last length.
    q = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((1, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    ms, plain = per_layer(
        lambda i: dm.decode_attention_update_quantized_stacked(
            q, kn, kn, *args, i % L, lens, scale=scale, window=windows[i % L]),
        lambda i: dm.decode_attention_update_plain(
            q, kn, kn, *args, i % L, lens, scale=scale, window=windows[i % L]))
    kd = dequantize_kv(cache.k[0], cache.k_scale[0]).repeat_interleave(groups, dim=1)
    vd = dequantize_kv(cache.v[0], cache.v_scale[0]).repeat_interleave(groups, dim=1)
    lib_by_w = {w: sdpa_rows(q, kd, vd, lens, w) for w in set(windows)}
    pos = sum(visited(length, w) for w in windows)
    nbytes = (2 * nkv * pos * (hd + 4)
              + L * (2 * nh * hd * 2 + 2 * nkv * hd * 2 + 2 * nkv * (hd + 4)))
    b_ms, b_by = bound(nbytes, 4 * nh * hd * pos, "f32", rate)
    rows.append(dict(row=3, name="decode_attention_update (hd 256)",
                     counter="decode_attention_update",
                     source="metalchat_tpu_torch/csrc/decode_attention.cu",
                     replaces="metalchat_tpu/ops/decode_attention_pallas.py:598",
                     ms=ms, plain_ms=plain, library_ms=library(lib_by_w.get),
                     bound_ms=b_ms, bound_by=b_by, launches=counts["decode_attention_update"],
                     unit=f"one {GEMMA_LABEL} decode step ({L} calls, 1 row, length {length}, "
                          f"{L - n_global} layers with window {cfg.sliding_window})"))
    del kd, vd

    # Row 4: one 640-token prefill over the phase's cache, dequantized.
    S = 640
    qf = torch.randn((1, S, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kf = dequantize_kv(cache.k[0, :, :, :S], cache.k_scale[0, :, :, :S])
    vf = dequantize_kv(cache.v[0, :, :, :S], cache.v_scale[0, :, :, :S])
    ms, plain = per_layer(
        lambda i: flash_attention(qf, kf, vf, 0, scale=scale, window=windows[i % L]),
        lambda i: flash_attention_plain(qf, kf, vf, 0, scale=scale, window=windows[i % L]))
    kr, vr = (t.repeat_interleave(groups, dim=1) for t in (kf, vf))
    qt = qf.transpose(1, 2)
    t = torch.arange(S, device=dev)

    def flash_lib(w):
        ok = t[None, :] <= t[:, None]
        if w >= 0:
            ok &= t[None, :] > t[:, None] - w
        return sm.device_ms(lambda i: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=ok), 8)

    lib_by_w = {w: flash_lib(w) for w in set(windows)}
    pairs = sum(sum(visited(p + 1, w) for p in range(S)) for w in windows)
    b_ms, b_by = bound(L * 2 * (2 * S * nh * hd + 2 * nkv * S * hd), 4 * hd * nh * pairs,
                       "bf16", rate)
    rows.append(dict(row=4, name="flash_attention (hd 256)", counter="flash_attention",
                     source="metalchat_tpu_torch/csrc/flash_attention.cu",
                     replaces="metalchat_tpu/ops/flash_attention_pallas.py:136",
                     ms=ms, plain_ms=plain, library_ms=library(lib_by_w.get),
                     bound_ms=b_ms, bound_by=b_by, launches=counts["flash_attention"],
                     unit=f"one {S}-token {GEMMA_LABEL} prefill ({L} calls, bf16; launches "
                          "count the phase's two prefills)"))
    del qf, kf, vf, kr, vr

    # Rows 8 and 5: 8 rows at lengths spread to 1024, the serve run's pool.
    c = serve["paged"]["engine"].cache
    Lp = c.k_pages.shape[0]  # the serve phase's depth (SERVE_LAYERS): pool layers cycled
    B, mp, psize = c.page_table.shape[0], c.page_table.shape[1], c.page_size
    T = mp * psize
    lengths = [(i + 1) * T // B for i in range(B)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = torch.randperm(B * mp, generator=gen, device=dev).to(torch.int32).reshape(B, mp)
    q = torch.randn((B, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    pool = (c.k_pages, c.v_pages, c.k_scale, c.v_scale)
    pos = sum(visited(n, w) for n in lengths for w in windows)
    io = L * (2 * B * nh * hd * 2 + B * 4)
    ops = 4 * nh * hd * pos
    ms, plain = per_layer(
        lambda i: pm.paged_decode_attention_update_stacked(
            q, kn, kn, *pool, table, lens, i % Lp, scale=scale, window=windows[i % L]),
        lambda i: pm.paged_decode_attention_update_plain(
            q, kn, kn, *pool, table, lens, i % Lp, scale=scale, window=windows[i % L]))
    kd = dequantize_kv(gather_pages_dense(c.k_pages[0], table),
                       gather_page_scales(c.k_scale[0], table)).repeat_interleave(groups, dim=1)
    vd = dequantize_kv(gather_pages_dense(c.v_pages[0], table),
                       gather_page_scales(c.v_scale[0], table)).repeat_interleave(groups, dim=1)
    lib_by_w = {w: sdpa_rows(q, kd, vd, lens, w) for w in set(windows)}
    del kd, vd
    b_ms, b_by = bound(2 * nkv * pos * (hd + 4) + io + L * B * mp * 4
                       + L * (2 * B * nkv * hd * 2 + 2 * B * nkv * (hd + 4)), ops, "f32", rate)
    unit = (f"one {GEMMA_LABEL} decode step ({L} calls, 8 rows, lengths "
            f"{lengths[0]}..{lengths[-1]}, {L - n_global} layers with window "
            f"{cfg.sliding_window})")
    rows.append(dict(row=8, name="paged_decode_attention_update (hd 256)",
                     counter="paged_decode_attention_update",
                     source="metalchat_tpu_torch/csrc/paged_attention.cu",
                     replaces="metalchat_tpu/ops/paged_attention_pallas.py:410",
                     ms=ms, plain_ms=plain, library_ms=library(lib_by_w.get),
                     bound_ms=b_ms, bound_by=b_by,
                     launches=serve["paged"]["counts"]["paged_decode_attention_update"],
                     unit=unit + "; launches from serve-gemma"))
    ms, plain = per_layer(
        lambda i: pm.paged_decode_attention_stacked(
            q, *pool, table, lens, i % Lp, scale=scale, window=windows[i % L]),
        lambda i: pm.paged_decode_attention_plain(
            q, *pool, table, lens, i % Lp, scale=scale, window=windows[i % L]))
    b_ms, b_by = bound(2 * nkv * pos * (hd + 4) + io + L * B * mp * 4, ops, "f32", rate)
    rows.append(dict(row=9, name="paged_decode_attention (hd 256)",
                     counter="paged_decode_attention",
                     source="metalchat_tpu_torch/csrc/paged_attention.cu",
                     replaces="metalchat_tpu/ops/paged_attention_pallas.py:491",
                     ms=ms, plain_ms=plain, library_ms=library(lib_by_w.get),
                     bound_ms=b_ms, bound_by=b_by,
                     launches=serve["paged"]["counts"]["paged_decode_attention"],
                     unit=unit + "; read-only, on no Gemma path the script drives "
                                 "(launches 0)"))
    kc, vc = (torch.randn((L, B, nkv, T, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    ms, plain = per_layer(
        lambda i: dm.decode_attention_stacked(q, kc, vc, i % L, lens, scale=scale,
                                              window=windows[i % L]),
        lambda i: dm.decode_attention_stacked_plain(q, kc, vc, None, None, i % L, lens,
                                                    scale=scale, window=windows[i % L]))
    kr, vr = (x[0].repeat_interleave(groups, dim=1) for x in (kc, vc))
    lib_by_w = {w: sdpa_rows(q, kr, vr, lens, w) for w in set(windows)}
    del kr, vr, kc, vc
    b_ms, b_by = bound(2 * nkv * pos * hd * 2 + io, ops, "f32", rate)
    rows.append(dict(row=5, name="decode_attention (hd 256)", counter="decode_attention",
                     source="metalchat_tpu_torch/csrc/decode_attention.cu",
                     replaces="metalchat_tpu/ops/decode_attention_pallas.py:323",
                     ms=ms, plain_ms=plain, library_ms=library(lib_by_w.get),
                     bound_ms=b_ms, bound_by=b_by, launches=counts["decode_attention"],
                     unit=unit.replace("decode step (", "decode step over a dense bf16 cache (")
                          + "; read-only, on no Gemma path the script drives (launches 0)"))
    for r in rows:
        r.update(route="cuda", max_abs_err=sm.err[r["counter"]])
        print(f"  {r['name']} [{r['unit']}]: {r['ms']:.5f} ms (bound {r['bound_ms']:.5f} ms, "
              f"{r['bound_by']}; plain {r['plain_ms']:.4f} ms; sdpa bf16 "
              f"{r['library_ms']:.5f} ms), launches {r['launches']}")
    return rows


def phase_timing_mixtral(sm: Smoke, run, scan, rate: float):
    """Row 1 with a device index at a batch-1 Mixtral decode step's shapes:
    the 192 expert calls (w1, w3, w2 of two distinct experts a layer, each a
    0-d index on the card into the flattened [256, out, k] stacks of phase
    mixtral's params) captured in one CUDA graph; plain version eager; the
    bound from the routed bytes (each entry's packed bytes and scales, the
    rows in and out); `torch._int_mm` at M=17 on unpacked int8 entries of
    the same stacks, by shape, as phase timing's yardstick. Rows 6 and 7:
    one step of 32 one-layer calls (the scan route) at the 8B shapes over
    the scan phase's int8 dense and paged caches at its last length, SDPA on
    the dequantized bf16 K/V as the yardstick."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm
    from metalchat_tpu_torch.ops.quant_matmul import unpack_int4

    cfg, params, _, counts, _, _ = run
    dev = torch.device("cuda")
    L, E, K = cfg.num_layers, cfg.num_experts, cfg.num_experts_per_tok
    layers = params["layers"]
    flat = {n: (layers[n].q.reshape((L * E,) + layers[n].q.shape[2:]),
                layers[n].scales.reshape((L * E,) + layers[n].scales.shape[2:]))
            for n in EXPERT_LEAVES}
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    host = torch.Generator()
    host.manual_seed(8)
    xs = {"w1": torch.randn((1, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16),
          "w2": torch.randn((1, cfg.intermediate_size), generator=gen, device=dev).to(
              torch.bfloat16)}
    xs["w3"] = xs["w1"]
    calls = []  # (leaf, entry): w1, w3, w2 of K distinct experts a layer
    for l in range(L):
        for e in torch.randperm(E, generator=host)[:K].tolist():
            for n in EXPERT_LEAVES:
                calls.append((n, torch.tensor(l * E + e, dtype=torch.int32, device=dev)))

    def call(i, fn):
        n, index = calls[i % len(calls)]
        return fn(xs[n], *flat[n], index, bits=4)

    n_calls = len(calls)
    ms = n_calls * sm.device_ms(lambda i: call(i, am.quant_matvec_stacked_fused), n_calls)
    plain = n_calls * sm.eager_ms(lambda i: call(i, am.quant_matvec_stacked_fused_plain), 3)
    b_ms = sum(a8_bound(flat[n][0], None, 1, rate)[0] for n, _ in calls)
    lib = {}
    for n in ("w1", "w2"):
        pq = flat[n][0]
        n_lib = max(1, math.ceil(120e6 / (pq.shape[1] * pq.shape[2] * 2)))
        unpacked = [unpack_int4(pq[l * E], -1).contiguous() for l in range(n_lib)]
        xq17 = torch.randint(-127, 128, (17, 2 * pq.shape[2]), generator=gen, device=dev,
                             dtype=torch.int8)
        lib[n] = sm.device_ms(lambda i: torch._int_mm(xq17, unpacked[i % n_lib].t()), 32)
        del unpacked
    lib_ms = sum(lib["w2" if n == "w2" else "w1"] for n, _ in calls)
    rows = [dict(row=1, name="a8_matvec indexed (Mixtral experts)", counter="a8_matvec_indexed",
                 source="metalchat_tpu_torch/csrc/a8_matvec.cu",
                 replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262", ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
                 launches=counts["a8_matvec_indexed"],
                 unit=f"one batch-1 {MIXTRAL_LABEL} decode step's {n_calls} routed expert "
                      "calls (a device index each, a8_quantize and the tensor-core matvec); "
                      "library: torch._int_mm at M=17 on unpacked entries; launches from "
                      "phase mixtral")]

    # Rows 6 and 7 over the scan phase's caches (8B shapes, one row).
    cfg8 = scan["cfg"]
    nh, nkv, hd, L8 = cfg8.num_heads, cfg8.num_kv_heads, cfg8.head_dim, cfg8.num_layers
    n = scan["length"]
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    q = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(scale=hd ** -0.5)
    c8, cp = scan["caches"]["int8"], scan["caches"]["paged"]
    table = cp.page_table
    dense = lambda i: (c8.k[i % L8], c8.v[i % L8], c8.k_scale[i % L8], c8.v_scale[i % L8])  # noqa: E731
    paged = lambda i: (cp.k_pages[i % L8], cp.v_pages[i % L8], cp.k_scale[i % L8],  # noqa: E731
                       cp.v_scale[i % L8])
    kd = dequantize_kv(c8.k[0, :, :, :n], c8.k_scale[0, :, :, :n]).repeat_interleave(
        nh // nkv, dim=1)
    vd = dequantize_kv(c8.v[0, :, :, :n], c8.v_scale[0, :, :, :n]).repeat_interleave(
        nh // nkv, dim=1)
    sdpa = L8 * sm.device_ms(lambda i: F.scaled_dot_product_attention(q[:, :, None, :], kd, vd),
                             64)
    io = 2 * nh * hd * 2 + 4
    for row, name, counter, fn, plain_fn, extra in (
            (6, "decode_attention_quantized (one layer)", "decode_attention_layer",
             lambda i: dm.decode_attention_quantized(q, *dense(i), lens, **kw),
             lambda i: dm.decode_attention_stacked_plain(
                 q, *(t[None] for t in dense(i)), 0, lens, **kw), 0),
            (7, "paged_decode_attention (one layer)", "paged_decode_attention_layer",
             lambda i: pm.paged_decode_attention(q, *paged(i), table, lens, **kw),
             lambda i: pm.paged_decode_attention_plain(
                 q, *(t[None] for t in paged(i)), table, lens, 0, **kw), table.numel() * 4)):
        ms = L8 * sm.device_ms(fn, 2 * L8)
        plain = L8 * sm.eager_ms(plain_fn, L8)
        b_ms, b_by = bound(L8 * (2 * nkv * n * (hd + 4) + io + extra), L8 * 4 * nh * hd * n,
                           "f32", rate)
        rows.append(dict(row=row, name=name, counter=counter,
                         source=("metalchat_tpu_torch/csrc/decode_attention.cu" if row == 6
                                 else "metalchat_tpu_torch/csrc/paged_attention.cu"),
                         replaces=("metalchat_tpu/ops/decode_attention_pallas.py:229" if row == 6
                                   else "metalchat_tpu/ops/paged_attention_pallas.py:167"),
                         ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=sdpa,
                         launches=scan["counts"][counter],
                         unit=f"one scan-route decode step of 8b-w4a8 ({L8} one-layer calls, "
                              f"1 row, length {n}, int8 "
                              + ("dense cache" if row == 6 else "pages of 256")
                              + "); launches from phase scan (its three caches)"))
    for r in rows:
        r.update(route="cuda", max_abs_err=sm.err[r["counter"]])
        print(f"  {r['name']} [{r['unit']}]: {r['ms']:.5f} ms (bound {r['bound_ms']:.5f} ms, "
              f"{r['bound_by']}; plain {r['plain_ms']:.4f} ms; library {r['library_ms']:.5f} "
              f"ms), launches {r['launches']}")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import metalchat_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (metalchat_tpu_torch "
              "not importable)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    sm = Smoke(torch)
    t_start = time.perf_counter()
    ffn_run = int4_run = stream_counts = gemma_run = serve_gemma = None
    mixtral_run = scan_run = serve_mixtral = chat_counts = cli_counts = cli_1b = None
    spec_counts = spec_fixture = None
    gpt2 = gpt2_fixture = ppl_counts = serve_gpt2 = gpt2_times = None
    qlora = gptq_run = qlora_times = train_counts = tp_counts = None
    tp_moe_counts = multihost_counts = tp_leaves_counts = train_tp_counts = None
    train_moe_counts = quality_counts = None
    smi = sm.phase("device", phase_device)
    dev_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {dev_name}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    if sm.phase("build", phase_build) is not None:
        sm.phase("kernels", lambda: phase_kernels(sm))
        sm.phase("fixture", lambda: phase_fixture(sm))
        sm.phase("fixture-int", lambda: phase_fixture_int(sm, FIXTURE_INT_DTYPE))
        main_run = sm.phase("main", lambda: phase_main(sm, dev_name))
        rows = None
        if main_run is not None:
            sm.phase("profile", lambda: phase_profile(sm, main_run))
            ffn_run = sm.phase("main-ffn-block",
                               lambda: phase_main_ffn_block(sm, main_run, dev_name))
        int4_run = sm.phase("main-int4", lambda: phase_main_int4(sm, dev_name))
        if int4_run is not None:
            sm.phase("profile-int4", lambda: phase_profile(sm, int4_run, "8b-int4"))
        if main_run is not None:
            stream_counts = sm.phase("stream", lambda: phase_stream(sm, main_run))
            chat_counts = sm.phase("chat", lambda: phase_chat(sm, main_run))
            tp_counts = sm.phase("tp", lambda: phase_tp(sm, main_run, smi))
            multihost_counts = sm.phase("multihost", lambda: phase_multihost(sm, main_run, smi))
        tp_moe_counts = sm.phase("tp-moe", lambda: phase_tp_moe(sm, smi))
        tp_leaves_counts = sm.phase("tp-leaves", lambda: phase_tp_leaves(sm, int4_run, smi))
        # Before the larger models load: GPTQ's f64 Hessians and their
        # factorization take tens of GB for a while.
        qlora = sm.phase("qlora-1b", lambda: phase_qlora_1b(sm, dev_name))
        if qlora is not None:
            train_counts = sm.phase("train", lambda: phase_train(sm, qlora, smi))
        gptq_run = sm.phase("gptq-1b", lambda: phase_gptq_1b(sm, dev_name))
        gemma_run = sm.phase("gemma", lambda: phase_gemma(sm, dev_name))
        sm.phase("gemma-fixture", lambda: phase_gemma_fixture(sm))
        if gemma_run is not None:
            train_tp_counts = sm.phase("train-tp", lambda: phase_train_tp(sm, gemma_run, smi))
        train_moe_counts = sm.phase("train-moe", lambda: phase_train_moe(sm, smi))
        sm.phase("mixtral-fixture", lambda: phase_mixtral_fixture(sm))
        mixtral_run = sm.phase("mixtral", lambda: phase_mixtral(sm, dev_name))
        if main_run is not None:
            scan_run = sm.phase("scan", lambda: phase_scan(sm, main_run))
            spec_counts = sm.phase("speculative", lambda: phase_speculative(sm, main_run, smi))
        spec_fixture = sm.phase("speculative-fixture", lambda: phase_speculative_fixture(sm))
        gpt2 = sm.phase("gpt2", lambda: phase_gpt2(sm, dev_name))
        gpt2_fixture = sm.phase("gpt2-fixture", lambda: phase_gpt2_fixture(sm))
        ppl_run = sm.phase("ppl", lambda: phase_ppl(sm))
        ppl_counts = None if ppl_run is None else ppl_run["counts"]
        if ppl_run is not None:
            quality_counts = sm.phase("quality", lambda: phase_quality(sm, ppl_run))
        ppl_run = None
        with timed_captures(torch):  # the engines' captures, timed
            fixture_counts = sm.phase("serve-fixture", lambda: phase_serve_fixture(sm))
            serve = None
            if main_run is not None:
                serve = sm.phase("serve", lambda: phase_serve(
                    sm, first_layers(main_run, SERVE_LAYERS["serve"], "serve"),
                    hbm_rate(dev_name)))
            if gemma_run is not None:
                serve_gemma = sm.phase("serve-gemma", lambda: phase_serve(
                    sm, first_layers(gemma_run, SERVE_LAYERS["serve-gemma"], "serve-gemma"),
                    hbm_rate(dev_name), GEMMA_LABEL, ("paged",)))
            if mixtral_run is not None:
                serve_mixtral = sm.phase("serve-mixtral", lambda: phase_serve(
                    sm, first_layers(mixtral_run, SERVE_LAYERS["serve-mixtral"],
                                     "serve-mixtral"),
                    hbm_rate(dev_name), MIXTRAL_LABEL, ("paged",)))
            if gpt2 is not None:
                serve_gpt2 = sm.phase("serve-gpt2", lambda: phase_serve(
                    sm, first_layers(gpt2[0], SERVE_LAYERS["serve-gpt2"], "serve-gpt2"),
                    hbm_rate(dev_name), GPT2_LABEL, ("paged",)))
            sm.phase("http", lambda: phase_http(sm))
        cli_counts = sm.phase("cli-fixture", lambda: phase_cli_fixture(sm))
        cli_1b = sm.phase("cli-1b", lambda: phase_cli_1b(sm))
        if main_run is not None:
            rows = sm.phase("timing", lambda: phase_timing(sm, main_run, hbm_rate(dev_name)))
        if serve is not None and fixture_counts is not None and rows is not None:
            # Rows 1 and 2 at one row move into the unit of their 8-row rows.
            one_row = {r["row"]: r for r in rows if r["row"] in (1, 2)}
            serve_rows = sm.phase("timing-serve", lambda: phase_timing_serve(
                sm, main_run, serve, fixture_counts, one_row, hbm_rate(dev_name)))
            rows = None if serve_rows is None else [
                r for r in rows if r["row"] not in one_row] + serve_rows
        if rows is not None and ffn_run is not None:
            more = sm.phase("timing-ffn", lambda: phase_timing_ffn(
                sm, main_run, ffn_run, hbm_rate(dev_name)))
            rows = None if more is None else rows + more
        if rows is not None and int4_run is not None:
            more = sm.phase("timing-int4", lambda: phase_timing_int4(
                sm, int4_run, hbm_rate(dev_name)))
            rows = None if more is None else rows + more
        if rows is not None and serve_gemma is not None:
            more = sm.phase("timing-gemma", lambda: phase_timing_gemma(
                sm, gemma_run, serve_gemma, hbm_rate(dev_name)))
            rows = None if more is None else rows + more
        if rows is not None and None not in (mixtral_run, scan_run, serve_mixtral):
            more = sm.phase("timing-mixtral", lambda: phase_timing_mixtral(
                sm, mixtral_run, scan_run, hbm_rate(dev_name)))
            rows = None if more is None else rows + more
        if rows is not None and gpt2 is not None:
            gpt2_times = sm.phase("timing-gpt2", lambda: phase_timing_gpt2(
                sm, gpt2[0], hbm_rate(dev_name)))
        if qlora is not None:
            qlora_times = sm.phase("timing-qlora", lambda: phase_timing_qlora(
                sm, qlora, hbm_rate(dev_name)))
        mixtral_counts = None if mixtral_run is None else mixtral_run[3]
        mixtral_run = None  # free the 23.5 GB of Mixtral weights
        if serve_mixtral is not None:
            serve_mixtral = {m: dict(counts=r["counts"]) for m, r in serve_mixtral.items()}
        torch.cuda.empty_cache()
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if (sm.failures or not smi or rows is None or None in (
            stream_counts, serve_mixtral, chat_counts, cli_counts, cli_1b, spec_counts,
            spec_fixture, gpt2, gpt2_fixture, ppl_counts, serve_gpt2, gpt2_times, qlora,
            gptq_run, qlora_times, train_counts, tp_counts, tp_moe_counts,
            multihost_counts, tp_leaves_counts, train_tp_counts, train_moe_counts,
            quality_counts)):
        print(f"chip_smoke: FAILED phases: {sm.failures}", file=sys.stderr)
        return 1
    by_path = {"generate 8b-w4a8": main_run[3], "generate 8b-w4a8 ffn_block": ffn_run[3],
               "generate 8b-int4": int4_run[3], "serve paged": serve["paged"]["counts"],
               "serve dense": serve["dense"]["counts"],
               "serve-fixture dense-act": fixture_counts["dense-act"],
               "stream 8b-w4a8": stream_counts, f"generate {GEMMA_LABEL}": gemma_run[3],
               f"serve {GEMMA_LABEL} paged": serve_gemma["paged"]["counts"],
               f"generate {MIXTRAL_LABEL}": mixtral_counts,
               f"serve {MIXTRAL_LABEL} paged": serve_mixtral["paged"]["counts"],
               "scan 8b-w4a8": scan_run["counts"], "chat 8b-w4a8": chat_counts,
               "cli 1b-w8a8": cli_1b, "cli-fixture int4": cli_counts["int4"],
               "speculative 8b-w4a8/1b-w8a8": spec_counts,
               "speculative-fixture": spec_fixture, "cli-fixture --draft": cli_counts["draft"],
               f"generate {GPT2_LABEL}": gpt2[0][3],
               f"generate {GPT2_LABEL} bf16 cache": gpt2[1],
               f"serve {GPT2_LABEL} paged": serve_gpt2["paged"]["counts"],
               "gpt2-fixture": gpt2_fixture, "ppl": ppl_counts, "quality": quality_counts,
               f"generate {QLORA_LABEL}": qlora[3], f"generate {GPTQ_LABEL}": gptq_run[3],
               f"generate {TRAIN_LABEL}": train_counts,
               "tp 8b-w4a8 generate (a rank)": tp_counts["generate"],
               "tp 8b-w4a8 serve paged (a rank)": tp_counts["serve"],
               "pp 8b-w4a8 generate (a stage)": tp_counts["pp_generate"],
               "pp 8b-w4a8 serve dense int8 (a stage)": tp_counts["pp_serve"],
               "cp 8b-w4a8 generate (a rank)": tp_counts["cp_generate"],
               "cp 8b-w4a8 serve dense int8 (a rank)": tp_counts["cp_serve"],
               "pp x cp 8b-w4a8 serve dense int8 (a stage)": tp_counts["pp_x_cp_serve"],
               f"tp-moe {MIXTRAL_LABEL} {MOE_TP_CUT['num_layers']} layers generate (a rank)":
                   tp_moe_counts["tp"],
               f"ep {MIXTRAL_LABEL} {MOE_TP_CUT['num_layers']} layers generate (a rank)":
                   tp_moe_counts["ep"],
               "multihost 8b-w4a8 MultiHostServer (a rank)": multihost_counts["server"],
               "multihost 8b-w4a8 MultiHostEngine (a rank)": multihost_counts["engine"],
               **{f"tp-leaves {n} steps (a rank)": c for n, c in tp_leaves_counts.items()},
               f"train-tp {GEMMA_LABEL} tp 2 prefill (a rank)": train_tp_counts["prefill"],
               f"train-tp {GEMMA_LABEL} tp 2 steps (a rank)": train_tp_counts["steps"],
               f"train-moe {TRAIN_MOE_LABEL} dp 2 x ep 2 steps (a rank)": train_moe_counts}
    for r in rows:
        counter = r.get("counter", r["name"])
        r["launches_by_path"] = {path: c[counter] for path, c in by_path.items()}
    rows.sort(key=lambda r: r["row"])
    keys = ("row", "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "unit", "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
