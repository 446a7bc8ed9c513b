#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--t SYMBOLS] [--seed N] [--out DIR]

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc/``
into ``build/`` (one ``nvcc`` per source, all started together), then
drives the port's paths once each, at full width, through the entry
points a user would call:

* DNA motif matching: build a motif DFA, ``tune_kernel`` the DNA
  automaton's launch parameters (map chunk, count chunk, threads, symbols
  a table lookup advances) on a text of 3 * 2^30 symbols resident on the
  card (the paper's human genome is 3.17 GB), store the winner, then
  ``configure`` the store and answer five motif-count requests through
  ``fa_match(tuned=True)``, each again under the profiler for its device
  time split into the state map (B1), the count (B2) and the rest;
* the streamed split (the paper's step): the same text copied back once
  into pinned host memory as 3072 rows of 2^20 symbols, 256 rows a batch;
  ``tune_stream_split`` searches the paper's split space (host threads x
  host affinity x host fraction, 108 points on 8 CPUs) with SAML within 5 %
  measured, once more from its store with no measurement; then
  ``serve_stream`` streams every batch through ``StreamingPipeline`` from
  the tuned split with the EWMA controller on: a ``host`` group runs the
  plain DFA on CPU threads, the ``card`` group copies its chunks on a side
  stream and counts them with B1 and B2 (``fa_match_rows``, one launch of
  each a chunk).  Every row's count must equal ``fa_match_rows_plain`` on
  the card, no group may fail, and the B1/B2 launches must equal the card
  group's dispatches; the same holds for two batches at a fixed host share
  of 2 rows a batch (both groups at work).  The same stream on the card
  alone (before and after it), the bare host -> card copy and the resident
  ``fa_match`` are timed beside it;
* the paper's search (no kernel of ours): ``fit_emil_surrogates`` fits
  the BDTR pair to the Emil platform model's 7200-experiment grid on the
  host; both models' ``predict_fn_torch`` and ``energy_fn_torch_builder``
  on the card must agree with numpy's float64 predictions within 1e-5
  relative over all 57,267 configurations of ``paper_space()``; then
  ``TuningSession(...).run("saml", engine="vectorized")`` runs 32 chains
  for 2000 iterations on the card for seeds 0, 1 and 2 (and on the CPU
  for seed 0 beside them), and each winner's measured time must lie
  within 5 % of EM's (the batched platform model over the whole space, on
  the host);
* LM serving: ``tune_kernel`` the flash-attention and decode-attention
  kernels at Qwen2.5-3B's serving shapes into one store, ``configure`` it,
  then ``serve_session`` a batch of 8 random 2048-token prompts and decode
  128 tokens greedily with the full-width model (36 layers, random weights
  from ``--seed``, bfloat16), prefill through the flash-attention kernel
  and every decoded token through the split-KV decode kernel;
* LM request serving: the same model, store and kernels under request
  traffic: ``serve_requests`` answers 96 requests arriving at 16 a second
  (a seeded Poisson source; 1, 2 or 4 rows each of a 32-token prompt and
  16 new tokens; 70 % interactive with a 1 s SLO, 30 % batch with 4 s)
  through SLO-aware admission, the continuous batcher and the chunked
  scheduler, each chunk a prefill and 15 decode steps on the card.  Every
  admitted request must end completed or shed exactly once, at least one
  must complete, serving must measure no configuration, the kernels'
  launches must be 36 (B3) and 36 x 15 (B4) a dispatch, and one recorded
  chunk's tokens must come out bit for bit the same when the same step
  runs it again; that chunk, teacher-forced on its own tokens, must hold
  every B3 and B4 call (at the request path's shapes and launches)
  against its plain version and its logits within 5 % of a run through
  the plain versions;
* LM training: ``train_loop`` takes four AdamW steps of the same model
  at full width and depth (float32 parameters and moments, bf16 compute,
  batch 2 x 2048 tokens from ``SyntheticPipeline(seed)``, each layer
  recomputed in the backward pass), every attention layer's forward
  through the flash-attention kernel and its gradient through the
  flash-attention backward kernels;
* ``save_dots_train``: the same model from the seed, one ``train_step``
  (AdamW) under ``remat=True`` and one under ``remat="save_dots"`` (each
  layer cut into checkpointed segments at the reference's named tensors:
  the projections, the mixer's and the MLP's outputs and ``x @ w_in``),
  each from the weights as built; the losses within 1e-3 relative, each
  parameter's gradient within 1e-2 relative L2 of full remat's, every
  B3/B5 call of the ``save_dots`` gradient pass within
  ``attention_parity``'s gates of its plain version, B3 2 x 36 and B5 36
  a program each step, peak bytes (``max_memory_allocated``) and step
  seconds of both; then the dry run of both steps (``StepBundle.dry_run``:
  the same steps on meta tensors, no card) must reckon each peak within
  10 % of the card's and count exactly the kernel launches the card made;
* four more decoders served (batch 8, a 2048-token prompt, 32 greedy
  tokens, random weights from ``--seed``, bf16, the kernels at their
  defaults): Phi-3-mini at full size (32 layers, 32 heads of 96, so the
  decode kernel at one query head a kv head), Qwen2-MoE-A2.7B at full size
  (60 experts top-4 plus 4 shared, in plain PyTorch), Nemotron-4-340B at
  full width cut to 2 of its 96 layers and built in bf16 (heads of 192),
  and InternVL2-76B at full width cut to 8 of its 80 layers, its prompt
  1024 patch embeddings and 1024 tokens through ``LM.prefill(
  patch_embeds=)``; each prefill through the flash-attention kernel, every
  decode step through the split-KV decode kernel;
* the encoder-decoder: Whisper-base at full size served (batch 8 of 1500
  frames, 128 greedy tokens): the encoder through the flash-attention
  kernel unmasked, every decode step's self-attention and its
  cross-attention over the whole encoder cache through the decode kernel;
  then trained (``train_loop``, 3 AdamW steps, float32 parameters, bf16
  compute, batch 8 x (1500 frames, 448 tokens), each layer recomputed in
  the backward pass): the encoder, the decoder's self-attention and its
  cross-attention (448 queries over 1500 keys) through the flash-attention
  kernel and its backward kernels;
* RWKV-6 serving: ``tune_kernel`` the wkv kernel at RWKV-6 1.6B's prefill
  shape and the selective-scan kernel at Jamba's into one store,
  ``configure`` it, then ``serve_session`` RWKV-6 1.6B at full width and
  depth (24 layers, random weights from ``--seed``, bfloat16): a batch of 8
  random 2048-token prompts and 128 greedy tokens, every layer's time mix
  through the wkv kernel in prefill and at every decode step;
* Jamba serving: the same on Jamba-v0.1 at full width, cut to its first
  8-layer period (its 103 GB of bf16 weights do not fit one 80 GB card):
  seven Mamba layers through the selective-scan kernel in prefill (decode
  steps them in plain PyTorch, as the reference does), the attention layer
  through the flash-attention kernel in prefill and the decode kernel at
  every step, and four MoE layers in plain PyTorch;
* RWKV-6 training: ``tune_kernel`` the wkv backward at RWKV-6's training
  shape and the selective-scan backward at Jamba's into the recurrent
  paths' store, then ``train_loop`` takes four AdamW steps of RWKV-6 1.6B at
  full width and depth (float32 parameters and moments, bf16 compute,
  batch 8 x 2048 from ``SyntheticPipeline(seed)``, each layer recomputed in
  the backward pass), every time mix's forward through the wkv kernel and
  its gradient through the wkv backward kernel;
* Jamba training: the same on Jamba-v0.1's first period at full width
  without experts (every channel the dense SwiGLU: with its experts the
  period's 13.3e9 parameters need 213 GB of training state), batch 2 x
  2048: seven Mamba layers through the selective-scan kernel and its
  backward kernel, the attention layer through the flash-attention kernels;
* distribution over ranks (``repro_torch.dist``): processes spawned from
  this script after the build share the card (gloo through a file
  rendezvous; each loads the built libraries and builds nothing), in two
  spawns: two ranks run every two-rank path below one after another, and
  four ranks the (2, 2) paths.  Phase
  ``seq_decode_parity``: B4 over each rank's stripe of a 32768-position
  cache at Qwen2.5-3B's decode heads (B 8), two ranks with
  ``kv_shard="seq"`` and a (2, 2) mesh of four with ``"batch_seq"``, at
  positions 37 (the second stripe empty: no launch), 16383, 16384 and
  32767, bf16 and float32, the combined output against B4 and the plain
  version over the whole cache within 2e-4, each stripe's lse against the
  plain lse within 1e-4, the stripes against the whole updated cache, B4
  launches exact; ``compressed_allreduce``: 2^20 float32 a rank, int8
  within max|x| / 100 of the mean and top-k equal to the mean of the
  decompressed contributions, with the wire bytes of ``dp_train``'s
  gradients; ``seq_serve``: two ranks serve Qwen2.5-3B at full size with
  each attention cache in two stripes of 8200 (batch 1, a 16384-token
  prompt prefilled whole on both, 16 greedy tokens), the same tokens on
  both, B3 36 and B4 36 x 15 a rank, no configuration measured, a decode
  step profiled for the combine's share, and on rank 0 the logits within
  5 % of a one-process run with the whole cache; ``dp_train``: Qwen2.5-3B
  cut to 2 of its 36 layers at full width trained data-parallel (4 x 2048
  a step, 2 steps, remat) on two ranks against one rank of the same
  global batch in float32 with TF32 off (losses within 2e-4), then in bf16
  with and without int8 gradient compression (final losses within 0.1),
  B3/B5 launches exact on each rank.  Tensor, expert and FSDP parameter
  sharding (A6b): ``tp_serve``: two ranks of a (1, 2) mesh serve
  Qwen2.5-3B at full size with its heads split (``kv_shard="heads"``: 8 q
  heads over 1 kv head a rank; batch 4, prompt 1024, 16 tokens), the same
  tokens on both, B3 36 and B4 36 x 15 a rank, every B3 and B4 call of a
  prefill and a decode step on rank 0 within its plain version's gate, a
  decode step's collectives counted, and the logits within 5 % of the
  same weights teacher-forced in one process; ``sharded_train``:
  Qwen2-MoE at full width cut to its first layer, float32 with TF32 off,
  on a (2, 2) mesh of four (the model axis splitting the heads, the shared
  expert's columns, the vocabulary and the 60 experts, FSDP over data,
  ``seq_parallel``, 2 microbatches, remat; 4 x 512, 2 steps) against the
  same run in one process (losses within 2e-4, B3/B5 launches equal on
  every rank), each rank's resident parameter and moment bytes and the
  collectives of a step by op and axes.  The layouts of A6c:
  ``tp_recurrent``: two ranks of a (1, 2) mesh serve
  RWKV-6 1.6B at full width cut to 2 of its 24 layers on 16 of its 32
  heads a rank (bf16, batch 2, a 256-token prompt through B8's chunked
  route, 16 tokens through its serial route) and train it two float32
  steps (TF32 off, 2 x 512; B9 on the same heads), then Jamba's first
  layer (Mamba and the dense SwiGLU) the same way under ``mamba_tp`` (B6
  and B7 on 4096 of its 8192 channels a rank; ``in_proj`` on two strided
  ranges of its columns), then serve Whisper-base at full size on 4 of
  its 8 heads a rank in float32 and in bf16 (1500 frames, 16 tokens) and
  train it two float32 steps on them (2 x 1500 frames; B5): the same
  tokens on both ranks, B3/B4/B5/B6/B7/B8/B9 launches exact a rank, rank
  0's B8 and B6 calls of a prefill and a decode step and its B8/B9 and
  B6/B7 calls of the first training step within ``scan_parity``'s gates
  of their plain versions, the bf16 logits teacher-forced in one process
  within 5 %, each step's loss within 2e-4 of one process's and the
  parameters' update against one process's (at most 1 % of a leaf's
  entries off by a quarter of its largest update), Whisper's float32
  tokens those of one process; tokens/s, peak GiB, resident bytes and a
  step's collectives by op and axes recorded.  Ranks time-slice one
  card: their times say nothing about two or four cards.  Each serving
  path over ranks (``seq_serve``, ``tp_serve``, ``tp_recurrent``) also
  serves once more with no synchronize around its collectives and no
  logits kept (``uncounted``: the tokens/s a user sees); every multi-rank
  path records its collectives' calls and bytes a step (or a generated
  token) beside its seconds;
* the examples' twins (``examples/torch_*.py``, each through its
  ``main``): ``example_dna_real`` (``torch_dna_autotune.real()``: EM over
  8 chunks and SAM of ``fa_match`` on 4,000,000 symbols, every count
  against the plain version's on the card, B1/B2 launches two a
  measurement), ``example_serve_lm`` (``torch_serve_lm``: the smoke
  config, batch 4, prompt 32, 24 tokens; exact B3/B4),
  ``example_train_100m`` (``torch_train_lm --preset 100m``: the
  reference's ~100M Qwen-family model, 300 steps of 8 x 256 (its
  checkpoints every 250 steps here, the reference's 50 by default) under
  deterministic algorithms, every loss finite,
  the first within 0.5 of ln V, the last 20's mean below the first 20's,
  B3 and both B5 programs 10 a step; the same command on a directory
  holding only the step-250 checkpoint must end with the step-300
  parameters bit for bit; each checkpoint's save timed and one more
  step profiled) and ``example_elastic`` (``torch_elastic_restart`` in
  the two-rank spawn: a failure at step 7 resumed from 4, FSDP over
  data, then phase 2 on ``make_host_mesh(1)``, rank 0 resuming at 12 and
  rank 1 taking no part; held to an uninterrupted two-rank run).  After
  each phase's release the card's ``memory_allocated`` is emitted
  (``release`` lines).

Before each path it holds each of the path's kernels against its plain
PyTorch version on the same inputs at the path's shapes (the DNA kernels
exactly at S = 7 and 9 and every gram, at S = 21 (the state map's gather
route) and on an unaligned slice of the text, each with its route and the
three reckonings of its design: bytes, shared memory, instructions; the
attention
kernels also in both builds at hd 64 and 96 with ragged T, a q_offset and
no mask, the backward run twice for the same bits, the decode kernel (one
launch a call, its split combine inside) at length 37 where most segments
lie past the fill, twice for the same bits, at phi3-mini's hd 96 and at hd
192; the flash-attention backward also at hd 192 in bf16; the wkv
forward's chunked route and the wkv backward also with a quarter of their
decays below 2.1e-9 (the forward also with some 0), at hd 48 and twice for
the same bits, the forward's serial route at T = 1; the selective-scan
backward also with a quarter of its channels' decays 0 in float32; the
redesigned kernels' programs timed apart; every
tune must store a point no slower than the default it
measured); after each
serving path it runs the same weights with the kernels and with the plain
versions, teacher-forced on the generated tokens, and compares logits
(Qwen2.5-3B on its first 64 tokens, the recurrent paths on their first
32 after the first 512 prompt tokens, also in float32, where the gate
sits, with the MoE
choices pinned to the kernel run's; Whisper's run holds every kernel call
against its plain version as well); the new serving paths also check that
serving measured no launch configuration;
before each training path it compares the loss and every parameter's
gradient the same way (the recurrent ones in float32 compute, each held
against a float64 pass by its parameter's gate, with one wrong backward
per new kernel run as a control; their bf16 gradients are read against
the same float64 pass, per parameter, and reported).  Each path's launch
counters are set to 0 just before it and read just after it.  After the
Qwen training path, the restart drill (``run_with_restarts`` with a
failure injected at step 7, checkpoints every 4 steps) runs the Qwen2.5-3B
and RWKV-6 smoke configs on the card under
``torch.use_deterministic_algorithms(True)`` and must end bitwise where an
uninterrupted run does; ``CUBLAS_WORKSPACE_CONFIG`` is set for it before
torch starts.

Each phase prints one JSON line; any failing phase raises, so the script
exits non-zero and prints no result line.  It needs one CUDA device and
exits non-zero without one.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

``bound_ms`` in the kernels line is the least time the card could take:
the larger of (bytes each input is read once + each output written once)
/ 3.35e12 B/s (H100 SXM HBM3 bandwidth, NVIDIA data sheet) and the
operations over the data sheet's peak rate for their type: one integer
table lookup per symbol and start state over 33.5e12 op/s for the DNA
kernels (the sheet's 67 TFLOP/s of non-tensor float32 counts a fused
multiply-add as two, so 33.5e12 instructions per second; the same rate is
taken for int32 instructions), the attention's flops over 989e12
FLOP/s (dense bfloat16 tensor cores) for the attention kernels, the
backward counting the five products a backward needs (its two programs
do seven: ``bound_7_products_ms`` in its phase line), the FMAs of the wkv
kernel's chunked route over 33.5e12/s, three a (token, head, i, j) state
cell (one in the states program, the state's step and r . S in the chunk
program; bytes bound it: ``t1_bound_ms`` is a decode step's, the state
read and written), and for the selective scan the larger of one exp per (token,
channel, state) cell on the special-function units (16 a clock per SM,
the CUDA C++ Programming Guide's throughput table for compute capability
9.0, on 132 SMs at the 1.98 GHz boost clock: 4.18e12/s) and four float32
instructions per cell over 33.5e12/s.  The backward kernels: the wkv
backward the FMAs of its chunked form over 33.5e12/s, 5 hd^2 + 6 chunk hd
a token and head (the products with the chunk's entry state and exit
adjoint, one a state cell in each scan, the in-chunk pairs; the serial
form's eight instructions a state cell stand beside it in its phase line,
``bound_8_per_cell_ms``), the selective-scan backward the larger of one
exp per cell on the SFUs and eight float32 instructions per cell.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS gives the same bits run to run only with a fixed workspace, and
# deterministic mode refuses it without one: set before torch starts CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
STARTED = time.perf_counter()       # each JSON line's "at_s" counts from it
sys.path.insert(0, str(ROOT / "src"))

FULL_T = 3 * 2 ** 30
HBM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 33.5e12
BF16_FLOPS_PER_S = 989e12
SERVE_MOTIFS = ("ACGTAC", "GATTAC", "TTAGGG", "CCGGAA", "ACGTACGT")
SFU_OPS_PER_S = 16 * 132 * 1.98e9
LIBRARIES = ("dna_automaton", "flash_attention", "flash_attention_bwd",
             "decode_attention", "mamba_scan", "mamba_scan_bwd", "rwkv6_wkv",
             "rwkv6_wkv_bwd")
# the LM path: Qwen2.5-3B, batch 8, a 2048-token prompt, 128 new tokens;
# lm_parity teacher-forces the first LM_PARITY_STEPS of them
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen2.5-3b", 8, 2048, 128
LM_PARITY_STEPS = 64
# the request path: the same model under 96 requests at 16 a second, each
# of 1, 2 or 4 rows of a 32-token prompt and 16 new tokens (the reference
# CLI's prompt and gen, the source's default mix)
REQ_N, REQ_RATE, REQ_PROMPT, REQ_GEN = 96, 16.0, 32, 16
# the paper's search: vectorized SAML chains, iterations, seeds on the card
# and on the CPU beside them (the host's run is timed, not gated); the gates
SEARCH_CHAINS, SEARCH_ITERATIONS, SEARCH_SEEDS = 32, 2000, (0, 1, 2)
SEARCH_CPU_SEEDS = (0,)
SEARCH_PREDICT_RTOL, SEARCH_EM_GAP = 1e-5, 0.05
# the training path: the same model, batch 2 x 2048 tokens, 4 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# the recurrent serving paths: batch 8, a 2048-token prompt, 128 new tokens;
# Jamba cut to its first 8-layer period
RWKV_ARCH, JAMBA_ARCH, JAMBA_LAYERS = "rwkv6-1.6b", "jamba-v0.1-52b", 8
SSM_BATCH, SSM_PROMPT, SSM_GEN = 8, 2048, 128
# the recurrent parity phases teacher-force the first SSM_PARITY_STEPS of
# the SSM_GEN served tokens after the first SSM_PARITY_PROMPT tokens of the
# prompt (room in the time limit: five passes, three of them through the
# plain versions' loops over every prompt token)
SSM_PARITY_STEPS, SSM_PARITY_PROMPT = 32, 512
# the recurrent training paths: RWKV-6 1.6B at batch 8 x 2048 (B.H = 256
# recurrences, the serving shape) and Jamba's first period without experts
# at batch 2 x 2048, 4 steps each.  Their kernels-vs-plain gradient passes
# run at batch 2: Jamba at 256 tokens, RWKV-6 at 128 (the plain versions
# are Python loops over the tokens, the parity phase runs them three times,
# and RWKV-6 has 24 recurrent layers to Jamba's 7; scan_bwd_parity holds
# B7 and B9 at the training shapes)
RWKV_TRAIN_BATCH, JAMBA_TRAIN_BATCH = 8, 2
SSM_PARITY_BATCH = 2
SSM_PARITY_SEQ = {"rwkv6-1.6b": 128, "jamba-v0.1-52b": 256}
# the other decoders served at full width (A4) and the VLM (A5): batch 8, a
# 2048-token prompt (the VLM's: 1024 patch embeddings, then 1024 tokens),
# 32 new tokens; nemotron-4 cut to 2 of its 96 layers and built in bf16,
# InternVL2 to 8 of its 80 (phase, arch, layers kept or None, build dtype)
DEC_BATCH, DEC_PROMPT, DEC_GEN = 8, 2048, 32
DECODER_PHASES = (("phi3_serve", "phi3-mini-3.8b", None, None),
                  ("moe_serve", "qwen2-moe-a2.7b", None, None),
                  ("nemotron_serve", "nemotron-4-340b", 2, "bfloat16"),
                  ("vlm_serve", "internvl2-76b", 8, None))
# the encoder-decoder (A5): Whisper-base at full size, batch 8 of 1500
# frames (a 30 s window after its conv stem), 128 new tokens served;
# trained at batch 8 x (1500 frames, 448 tokens) for 3 steps
WHISPER_ARCH, WHISPER_BATCH, WHISPER_FRAMES = "whisper-base", 8, 1500
WHISPER_GEN, WHISPER_TRAIN_STEPS = 128, 3


def roofline_ms(n_bytes: float, n_ops: float, ops_per_s: float
                ) -> tuple[float, str]:
    """The least time (ms) for the work and what sets it: the bytes over the
    HBM rate or the operations over ``ops_per_s``."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


# files every emitted line is appended to as well (``--out``)
EMIT_TO: list = []


def emit(**fields) -> None:
    fields.setdefault("at_s", round(time.perf_counter() - STARTED, 3))
    line = json.dumps(fields)
    print(line, flush=True)
    for path in EMIT_TO:
        with open(path, "a") as f:
            f.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_ms(fn, repeats: int) -> float:
    """Mean device time of ``fn`` over ``repeats`` back-to-back calls: CUDA
    events, the card held by a spin while the host enqueues the calls (the
    tuner's timing, ``repro_torch.tune.kernels.evaluate``), so a call of
    short launches is not timed at the host's pace.  Calls ``fn`` once
    more first, to measure the host's enqueue time."""
    from repro_torch.tune.kernels.evaluate import (device_seconds,
                                                   probe_seconds)

    host_s, _ = probe_seconds(fn, torch.device("cuda"))
    return device_seconds(fn, repeats, host_s) * 1e3


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # two ranks on one card (the dist/ phases) need compute mode Default
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         compute_mode=mode)
    return smi


def kernel_name(mangled: str) -> str:
    """``flash_fwd_bf16_kernel<128,2>`` from a mangled kernel name: the
    length-prefixed name ending in ``_kernel``, its element type where it
    is a template argument, and its integer template arguments."""
    base = mangled
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n = int(mangled[i:run.end()])
            cand = mangled[run.end():run.end() + n]
            if len(cand) == n and cand.endswith("_kernel"):
                base = cand
                break
        if base != mangled:
            break
    args = re.findall(r"L[ib](\d+)E", mangled)
    if base + "I13__nv_bfloat16" in mangled:
        args.insert(0, "bf16")
    elif base + "If" in mangled:
        args.insert(0, "float")
    return base + ("<" + ",".join(args) + ">" if args else "")


def ptxas_report(name: str) -> list[str]:
    """What ptxas reported of a library's registers and spills, one line a
    kernel: its name with its template arguments (``<128,2>``), then the
    registers and spill bytes."""
    from repro_torch import _build

    out, kernel = [], None
    for line in _build.build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: {line.strip().removeprefix('ptxas info    : ')}")
    return out


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    _build.load_libraries(LIBRARIES)
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(name) for name in LIBRARIES}
    emit(phase="build", seconds=round(seconds, 3),
         libraries=[str(_build.library_path(n).relative_to(ROOT))
                    for n in LIBRARIES],
         flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas)


def phase_oracle(seed: int) -> None:
    """Kernel path vs the sequential oracle vs the plain path: exact."""
    from repro_torch.kernels.dna_automaton import ops, ref

    cases = []
    text = ops.random_dna_text(2 ** 20, seed=seed, device="cuda")
    small = text[:10000].contiguous()
    for motif in ("ACGTAC", "AAAA"):
        table, accept = ops.build_motif_dfa(motif)
        for txt, chunk in ((text, 2048), (small, 512)):   # 512 clamps to 500
            got = int(ops.fa_match(txt, table, accept, chunk=chunk,
                                   tuned=False))
            plain = int(ops.fa_match_plain(txt, table, accept, chunk=chunk))
            want, _ = ref.fa_match_ref(txt, table, accept)
            check(got == want == plain,
                  f"oracle: motif {motif} t={txt.shape[0]} chunk={chunk}: "
                  f"kernel {got}, plain {plain}, sequential {want}")
            cases.append({"motif": motif, "t": txt.shape[0], "chunk": chunk,
                          "count": got})
    emit(phase="oracle", ok=True, cases=cases)


DNA_MOTIFS = {7: "ACGTAC", 9: "ACGTACGT", 21: "ACGTTGCAAGCTTCGAACGT"}


def phase_kernels(text) -> list[dict]:
    """B1 and B2 against their plain versions, exactly (``torch.equal``):
    at the full text with S = 7 and S = 9 at the defaults and at each
    ``gram``, with a 20-letter motif (S = 21, the gather route) on 2^28
    symbols, and on the unaligned slice ``text[1:1 + 2^24]``; each case
    with its route, time, bound and three reckonings.  Returns the
    kernels' records at the defaults and S = 7 (their ``launches`` are
    filled in after the main path ran)."""
    from repro_torch.convert import dfa_to_device
    from repro_torch.kernels.dna_automaton import kernel, ops

    d = ops.DEFAULTS
    mc, cc, bt = d["map_chunk"], d["count_chunk"], d["block_threads"]
    source = "src/repro_torch/kernels/csrc/dna_automaton.cu"
    t_full = text.shape[0]

    def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
        return roofline_ms(n_bytes, n_ops, INSTR_PER_S)

    def plain_run(fn, timed: bool):
        """``fn``'s output, and where ``timed`` its time (ms): a second,
        warm call between two CUDA events.  A plain version is a Python
        loop of 65,536 steps that takes seconds; ``device_ms``'s probe
        and spin would take two calls' time more."""
        from repro_torch.tune.kernels.evaluate import probe_seconds

        out = fn()
        if not timed:
            return out, None
        _, seconds = probe_seconds(fn, torch.device("cuda"))
        return out, seconds * 1e3

    cases, records = [], []
    for s, txt, grams, timed in ((7, text, kernel.GRAMS, True),
                                 (9, text, kernel.GRAMS, True),
                                 (21, text[:2 ** 28], (d["gram"],), True),
                                 (7, text[1:1 + 2 ** 24], (d["gram"],), False),
                                 (9, text[1:1 + 2 ** 24], (d["gram"],), False)):
        table, accept = dfa_to_device(*ops.build_motif_dfa(DNA_MOTIFS[s]),
                                      "cuda")
        t = txt.shape[0]
        route = kernel.route_of(s)
        full_defaults = t == t_full and s == 7
        want_maps, map_plain_ms = plain_run(
            lambda: kernel.state_map_plain(txt, table, chunk=mc),
            full_defaults)
        prefix = ops.compose_maps(want_maps)
        rep = cc // mc
        starts = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                            prefix[rep - 1::rep, 0][:t // cc - 1]])
        del prefix
        want_counts, count_plain_ms = plain_run(
            lambda: kernel.count_hits_plain(txt, table, accept, starts,
                                            chunk=cc), full_defaults)
        for gram in grams:
            launch = {"block_threads": bt, "gram": gram}
            maps = kernel.state_map(txt, table, chunk=mc, **launch)
            got = kernel.count_hits(txt, table, accept, starts, chunk=cc,
                                    **launch)
            torch.cuda.synchronize()
            ok_map = torch.equal(maps, want_maps)
            ok_count = all(torch.equal(g, w) for g, w in zip(got, want_counts))
            case = {"s": s, "t": t, "unaligned": txt.data_ptr() % 16 != 0,
                    "gram": gram, "route": route, "state_map_equal": ok_map,
                    "count_hits_equal": ok_count}
            if timed:
                case["state_map_ms"] = device_ms(lambda: kernel.state_map(
                    txt, table, chunk=mc, **launch), 5)
                case["count_hits_ms"] = device_ms(lambda: kernel.count_hits(
                    txt, table, accept, starts, chunk=cc, **launch), 5)
                case["state_map_reckon"] = kernel.reckonings(
                    route, t, s, gram, chunk=mc, threads=bt)
                case["count_hits_reckon"] = kernel.reckonings(
                    "count", t, s, gram, chunk=cc, threads=bt)
            cases.append(case)
            check(ok_map and ok_count, f"kernel_parity: DNA case {case}")
            if full_defaults and gram == d["gram"]:
                n_maps, n_counts = t // mc, t // cc
                b_ms, b_by = bound(t + 4 * table.numel() + 4 * n_maps * s,
                                   t * s)
                records.append({
                    "name": "dna_state_map", "ok": ok_map, "route": "cuda",
                    "source": source,
                    "replaces": "src/repro/kernels/dna_automaton/kernel.py:54",
                    "launches": 0,
                    "max_abs_err": max_abs_err([maps], [want_maps]),
                    "ms": case["state_map_ms"], "plain_ms": map_plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
                b_ms, b_by = bound(t + 4 * table.numel() + 4 * s
                                   + 3 * 4 * n_counts, t)
                records.append({
                    "name": "dna_count_hits", "ok": ok_count, "route": "cuda",
                    "source": source,
                    "replaces": "src/repro/kernels/dna_automaton/kernel.py:94",
                    "launches": 0, "max_abs_err": max_abs_err(got, want_counts),
                    "ms": case["count_hits_ms"], "plain_ms": count_plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
                total_count = int(got[0].sum())
                maps_default = maps
            del maps, got
        del want_maps, want_counts, starts
        torch.cuda.empty_cache()

    # where one fa_match at the defaults spends its time: the two kernels
    # above, the plain-PyTorch prefix compose between them, and the rest
    compose_ms = device_ms(lambda: ops.compose_maps(maps_default), 3)
    del maps_default
    table, accept = ops.build_motif_dfa(DNA_MOTIFS[7])
    ops.fa_match(text, table, accept, tuned=False)      # warm the allocator
    fa_match_ms = device_ms(lambda: ops.fa_match(text, table, accept,
                                                 tuned=False), 3)
    emit(phase="kernel_parity", t=t_full, defaults=dict(d),
         total_count=total_count, compose_maps_ms=compose_ms,
         fa_match_default_ms=fa_match_ms, cases=cases,
         results=[{k: r[k] for k in ("name", "ok", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms")}
                  for r in records])
    for r in records:
        check(r["ok"], f"{r['name']} disagrees with its plain version "
                       f"(max abs err {r['max_abs_err']})")
    return records


def phase_tune(t: int, seed: int, store_path: Path):
    from repro_torch.tune import kernels as ktune

    t0 = time.perf_counter()
    out = ktune.tune_kernel("dna_automaton", {"t": t}, store=store_path,
                            seed=seed)
    seconds = time.perf_counter() - t0
    default_s, best_s = out.default_time(), out.best_time()
    check(not out.result.from_cache, "tune: first tune came from the cache")
    check(out.n_measured <= 25, f"tune: measured {out.n_measured} > 25")
    check(out.measured_fraction <= 0.05,
          f"tune: measured fraction {out.measured_fraction} > 0.05")
    check(out.timer.n_launch_failed == 0,
          f"tune: {out.timer.n_launch_failed} launches refused: "
          f"{out.timer.rejected}")
    check(best_s <= default_s,
          f"tune: best {best_s} s slower than default {default_s} s")
    again = ktune.tune_kernel("dna_automaton", {"t": t}, store=store_path,
                              seed=seed)
    check(again.result.from_cache and again.n_measured == 0,
          "tune: repeat was not a zero-measurement cache hit")
    check(again.best_config == out.best_config, "tune: cached config differs")
    emit(phase="tune", ok=True, seconds=round(seconds, 3),
         space_size=out.space_size, n_measured=out.n_measured,
         measured_fraction=out.measured_fraction,
         n_launch_failed=out.timer.n_launch_failed,
         default_config=out.default_config, default_ms=default_s * 1e3,
         best_config=out.best_config, best_ms=best_s * 1e3,
         repeat_from_cache=again.result.from_cache,
         repeat_n_measured=again.n_measured)
    return out


def phase_serve(text, store_path: Path, tuned) -> None:
    from repro_torch.kernels.dna_automaton import kernel, ops
    from repro_torch.tune import kernels as ktune

    ktune.configure(store_path)
    n_measured = tuned.timer.n_measured
    t = text.shape[0]
    requests = []
    for motif in SERVE_MOTIFS:
        table, accept = ops.build_motif_dfa(motif)
        resolved = ktune.resolve_config(
            "dna_automaton", {"t": t, "s": table.shape[0]}, "uint8",
            device="cuda")
        hit = table.shape[0] == tuned.shape["s"]
        check(resolved == (tuned.best_config if hit else {}),
              f"serve: motif {motif} resolved {resolved}")
        before = (kernel.state_map.launches, kernel.count_hits.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = int(ops.fa_match(text, table, accept, tuned=True))
        seconds = time.perf_counter() - t0
        after = (kernel.state_map.launches, kernel.count_hits.launches)
        check(after == (before[0] + 1, before[1] + 1),
              f"serve: launch counters went {before} -> {after}")
        # the same request again under the profiler: its device time split
        # into B1, B2 and the rest (compose_maps and the start states)
        split = device_split(lambda: ops.fa_match(text, table, accept,
                                                  tuned=True))
        again = (kernel.state_map.launches, kernel.count_hits.launches)
        check(again == (after[0] + 1, after[1] + 1),
              f"serve: launch counters went {after} -> {again}")
        want = int(ops.fa_match_plain(text, table, accept))
        check(count == want,
              f"serve: motif {motif}: kernel path {count}, plain path {want}")
        parts = split["split_ms"]
        requests.append({"motif": motif, "s": table.shape[0],
                         "store_hit": hit, "count": count,
                         "ms": seconds * 1e3, "symbols_per_s": t / seconds,
                         "device_ms": {
                             "state_map": parts.get("dna_state_map (B1)"),
                             "count_hits": parts.get("dna_count_hits (B2)"),
                             "compose_and_rest": parts.get("other"),
                             "busy": split["device_busy_ms"],
                             "wall": split["wall_ms"]}})
    check(tuned.timer.n_measured == n_measured,
          "serve: answering requests measured new configurations")
    ktune.disable()
    emit(phase="serve", ok=True, requests=requests)


# -- the streamed host/card split (A1) ----------------------------------------------

# the stream: the text laid out as rows of 2^20 symbols, 256 rows a batch
STREAM_ROW_LEN, STREAM_BATCH, STREAM_MOTIF = 2 ** 20, 256, "ACGTAC"
# chunks a group's share of a batch is cut into (copy k + 1 overlaps the
# kernels of chunk k)
STREAM_CHUNKS = 4
# the two-group run: the host's rows of a batch, and its batches
HOST_SPLIT_ROWS, STREAM_SPLIT_BATCHES = 2, 2


def phase_stream(text, store_path: Path, seed: int):
    """The paper's step on its workload: the text streamed from pinned host
    memory and split between a host group (the plain DFA on CPU threads)
    and the card (B1/B2 through ``fa_match_rows``) at the split
    ``tune_stream_split`` finds in the paper's space, then every batch
    through ``serve_stream``'s ``StreamingPipeline`` with the EWMA
    controller on, and two batches at a fixed host share of 2 rows a batch.
    In both runs per-row counts must equal ``fa_match_rows_plain`` on the
    card; no group may fail; the card group must stay live, its B1/B2
    launches equal to its dispatches.  Beside them: the same stream on the
    card alone (before, between and after), the bare host -> card copy, the
    resident ``fa_match``.  Returns each run's launches by path
    (``dna_stream``, ``dna_stream_split``)."""
    import numpy as np

    from repro_torch.core.hetero import DeviceGroup
    from repro_torch.kernels.dna_automaton import kernel, ops
    from repro_torch.launch.serve import (serve_stream, split_space,
                                          tune_stream_split)
    from repro_torch.runtime import TuningStore, dna_stream_builder
    from repro_torch.tune import kernels as ktune

    t0_phase = time.perf_counter()
    card = text.device
    t = text.shape[0]
    rows = t // STREAM_ROW_LEN
    batch = min(STREAM_BATCH, rows)
    n_batches = rows // batch
    rows = n_batches * batch
    # the text starts in pinned host memory: the resident text copied back
    t0 = time.perf_counter()
    host = torch.empty(rows * STREAM_ROW_LEN, dtype=torch.uint8,
                       pin_memory=card.type == "cuda")
    host.copy_(text[:rows * STREAM_ROW_LEN])
    host_rows = host.view(rows, STREAM_ROW_LEN)
    pin_s = time.perf_counter() - t0
    batches = [{"text": host_rows[i * batch:(i + 1) * batch],
                "row": torch.arange(i * batch, (i + 1) * batch)}
               for i in range(n_batches)]
    gb = rows * STREAM_ROW_LEN / 1e9

    table, accept = ops.build_motif_dfa(STREAM_MOTIF)
    # B1/B2 tuned at the card group's chunk (a quarter of a batch) into
    # the same store: a store keyed by the whole text's length misses a
    # chunk's, and B2's default count chunk leaves a chunk of 64 rows
    # 1024 walkers
    chunk_t = batch * STREAM_ROW_LEN // STREAM_CHUNKS
    t0 = time.perf_counter()
    kt = ktune.tune_kernel("dna_automaton", {"t": chunk_t},
                           store=store_path, seed=seed, device=card)
    kernel_tune = {"t": chunk_t, "seconds": time.perf_counter() - t0,
                   "n_measured": kt.n_measured,
                   "measured_fraction": kt.measured_fraction,
                   "default_config": kt.default_config,
                   "default_ms": kt.default_time() * 1e3,
                   "best_config": kt.best_config,
                   "best_ms": kt.best_time() * 1e3}
    check(kt.measured_fraction <= 0.05 and kt.timer.n_launch_failed == 0,
          f"stream: B1/B2 tune at the chunk shape {kernel_tune}")
    ktune.configure(store_path, device=card)
    groups = [DeviceGroup("host", [torch.device("cpu")]),
              DeviceGroup("card", [card])]
    builder = dna_stream_builder(table, accept)

    # the split tune over the paper's space, on one representative batch
    workload = {"stream": "dna", "motif": STREAM_MOTIF, "rows": batch,
                "row_len": STREAM_ROW_LEN, "host_cpus": os.cpu_count()}
    split_store = TuningStore(store_path.with_name("split.json"),
                              device=card)
    measured: list = []
    kw = dict(groups=groups, space="paper", sample=batches[0],
              step_builder=builder, store=split_store, seed=seed,
              workload=workload, chunks_per_group=STREAM_CHUNKS,
              row_quantum=1, iterations=300, measurements=measured,
              device=card)
    t0 = time.perf_counter()
    shares, tuned = tune_stream_split(None, **kw)
    tune_s = time.perf_counter() - t0
    space = split_space()
    fraction = tuned.n_measured / space.size()
    check(not tuned.from_cache, "stream: first split tune came from the cache")
    check(fraction <= 0.05, f"stream: split tune measured {tuned.n_measured}"
                            f" of {space.size()} ({fraction})")
    before = dict(builder.dispatches)
    shares_again, again = tune_stream_split(None, **kw)
    check(again.from_cache and builder.dispatches == before
          and len(measured) == tuned.n_measured,
          "stream: the repeat split tune measured again")
    check(again.best_config == tuned.best_config
          and list(shares_again) == list(shares),
          "stream: the cached split differs")
    host_rates = [{"host_threads": m["host_threads"],
                   "host_affinity": m["host_affinity"],
                   "rows": m["rows_host"],
                   "gb_per_s": m["rows_host"] * STREAM_ROW_LEN / 1e9
                   / m["t_host"]} for m in measured if m["rows_host"] > 0]

    # every run below streams the same batches and is timed alike; they are
    # kept in the order they ran (the card alone before and after the
    # stream, and after the profiler) so that an order effect shows
    runs: list = []

    def timed(label, run_groups, run_shares, step_builder, run_batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_stream(None, groups=run_groups, batch=batch,
                           batches=run_batches, initial_shares=run_shares,
                           step_builder=step_builder,
                           chunks_per_group=STREAM_CHUNKS, row_quantum=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t = [r["t_step"] for r in out["records"]]
        n_gb = sum(b["text"].numel() for b in run_batches) / 1e9
        runs.append({"run": label, "s": seconds, "gb_per_s": n_gb / seconds,
                     "t_step_ms": [x * 1e3 for x in t],
                     "t_step_ms_median": float(np.median(t)) * 1e3,
                     "t_step_ms_std": float(np.std(t)) * 1e3})
        return out, seconds

    def capturing(seen):
        def wrap(group):
            fn = builder(group)

            def step(chunk):
                handle = fn(chunk)
                seen.append((chunk["row"], handle))
                return handle
            return step
        return wrap

    def exact_rows(seen, n_rows, what):
        got = torch.full((n_rows,), -1, dtype=torch.int32)
        for row, handle in seen:
            got[row] = handle.value.cpu()
        want = ops.fa_match_rows_plain(
            text[:n_rows * STREAM_ROW_LEN].view(n_rows, STREAM_ROW_LEN),
            table, accept).cpu()
        check(torch.equal(got, want), f"{what}: per-row counts differ from "
              f"fa_match_rows_plain in {int((got != want).sum())} rows")

    def counted_run(label, run_shares, run_batches):
        """One run with the launch counters from 0 just before it and read
        just after: no failure, the card group live, B1 = B2 = the card
        group's dispatches, every row exact."""
        seen: list = []
        kernel.state_map.launches = 0
        kernel.count_hits.launches = 0
        builder.dispatches.clear()
        out, seconds = timed(label, groups, run_shares, capturing(seen),
                             run_batches)
        launches = {"dna_state_map": kernel.state_map.launches,
                    "dna_count_hits": kernel.count_hits.launches}
        dispatches = dict(builder.dispatches)
        s = out["summary"]
        n_rows = len(run_batches) * batch
        check(s["failures"] == 0, f"{label}: {s['failures']} group failures")
        check(s["live_final"][1], f"{label}: the card group was demoted")
        check(launches["dna_state_map"] == launches["dna_count_hits"]
              == dispatches.get("card", 0) > 0,
              f"{label}: launches {launches}, card dispatches {dispatches}")
        check(s["rows_total"] == n_rows,
              f"{label}: {s['rows_total']} of {n_rows} rows")
        exact_rows(seen, n_rows, label)
        return out, seconds, launches, dispatches

    def rate(recs, gi):
        rows_g = sum(r["rows_completed"][gi] for r in recs)
        busy = sum(r["t_group"][gi] for r in recs if r["rows"][gi] > 0)
        return {"rows": rows_g, "busy_s": busy,
                "rows_per_s": rows_g / busy if busy > 0 else None,
                "gb_per_s": (rows_g * STREAM_ROW_LEN / 1e9 / busy
                             if busy > 0 else None)}

    timed("card_alone", groups[1:], None, builder, batches)
    # the streamed run: the tuned split, the EWMA controller on
    out, stream_s, launches, dispatches = counted_run("stream", shares,
                                                      batches)
    s, recs = out["summary"], out["records"]
    resolved = ktune.resolve_config(
        "dna_automaton", {"t": chunk_t, "s": table.shape[0]}, "uint8",
        device=card)
    check(resolved == kt.best_config,
          f"stream: the chunk shape resolved {resolved}")
    timed("card_alone", groups[1:], None, builder, batches)
    timed("stream", groups, shares, builder, batches)

    # the two-group path at a fixed host share (2 rows of a 256-row batch,
    # floored by the controller's minimum share): the host worker's plain
    # DFA beside the card's side-stream copies and kernels, the EWMA
    # moving rows; the card's chunks are not the tuned 2^26 shape, so B1/B2
    # resolve their defaults there
    host_pct = HOST_SPLIT_ROWS / batch * 100
    split_batches = batches[:STREAM_SPLIT_BATCHES]
    two, two_s, two_launches, two_dispatches = counted_run(
        "two_group", [host_pct / 100, 1 - host_pct / 100], split_batches)
    two_recs = two["records"]
    check(all(r["rows"][0] > 0 for r in two_recs),
          f"two_group: host rows {[r['rows'][0] for r in two_recs]}")
    check(two_dispatches.get("host", 0) > 0,
          f"two_group: host dispatches {two_dispatches}")

    # one batch of the stream under the profiler: the card's busy share;
    # then the card alone once more
    split = device_split(lambda: serve_stream(
        None, groups=groups, batch=batch, batches=batches[:1],
        initial_shares=shares, step_builder=builder,
        chunks_per_group=STREAM_CHUNKS, row_quantum=1))
    timed("card_alone_after_profiler", groups[1:], None, builder, batches)
    builder.close()

    # the yardsticks: the bare copy, the resident fa_match
    dst = torch.empty((batch, STREAM_ROW_LEN), dtype=torch.uint8,
                      device=card)
    copies = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches:
            dst.copy_(b["text"], non_blocking=True)
        end.record()
        end.synchronize()
        copies.append(start.elapsed_time(end))
    del dst
    fa_match_ms = device_ms(lambda: ops.fa_match(text, table, accept,
                                                 tuned=True), 3)
    ktune.disable()

    t_steps = [r["t_step"] for r in recs]
    emit(phase="stream", ok=True, rows=rows, row_len=STREAM_ROW_LEN,
         batch=batch, batches=n_batches, gb=gb, motif=STREAM_MOTIF,
         pin_copy_back_s=pin_s,
         split_tune={"space_size": space.size(),
                     "axes": {p.name: list(p.values) for p in space.params},
                     "best_config": tuned.best_config,
                     "n_measured": tuned.n_measured,
                     "measured_fraction": fraction, "seconds": tune_s,
                     "best_ms": tuned.best_energy_measured * 1e3,
                     "measured": measured, "host_rates": host_rates,
                     "repeat_from_cache": again.from_cache,
                     "repeat_new_dispatches": 0},
         shares=[float(x) for x in shares],
         stream={"s": stream_s, "gb_per_s": gb / stream_s,
                 "t_step_ms": [x * 1e3 for x in t_steps],
                 "t_step_ms_median": float(np.median(t_steps)) * 1e3,
                 "t_step_ms_std": float(np.std(t_steps)) * 1e3,
                 "host": rate(recs, 0), "card": rate(recs, 1),
                 "ewma_host_share": [float(r["shares"][0]) for r in recs],
                 "live_final": s["live_final"], "failures": s["failures"],
                 "launches": launches, "card_dispatches": dispatches,
                 "b1_b2_resolved": resolved},
         two_group={"host_pct": host_pct, "batches": len(split_batches),
                    "s": two_s, "host_setting": list(builder.host),
                    "rows_host": [r["rows"][0] for r in two_recs],
                    "t_step_ms": [r["t_step"] * 1e3 for r in two_recs],
                    "host": rate(two_recs, 0), "card": rate(two_recs, 1),
                    "ewma_host_share": [float(r["shares"][0])
                                        for r in two_recs],
                    "failures": two["summary"]["failures"],
                    "live_final": two["summary"]["live_final"],
                    "launches": two_launches,
                    "dispatches": two_dispatches},
         kernel_tune=kernel_tune,
         profiled_batch=split,
         runs=runs,
         copy_alone={"ms": copies, "gb_per_s": [gb / (c / 1e3)
                                                for c in copies]},
         fa_match_resident_ms=fa_match_ms,
         rows_exact=True, seconds=time.perf_counter() - t0_phase)
    del host, host_rows, batches
    return {"dna_stream": launches, "dna_stream_split": two_launches}


# -- the LM-serving path ------------------------------------------------------------

def phase_paper_search(seed: int) -> None:
    """The paper's search (A2): the surrogate pair fit on the host, its
    predictions on the card held against numpy's over the whole space,
    then vectorized SAML on the card (and on the CPU beside it) against EM.

    Tolerance: 1e-5 relative.  The card walks the trees in float32 (the
    numpy path in float64): the grid's features are small integers and
    multiples of 2.5, exact in both, so a threshold cannot flip, and 150
    float32 leaf values summed per model leave ~1e-6.  EM is exact here
    (noise-free oracle over all 57,267 points); each SAML winner's
    measured time must lie within 5 % of it.
    """
    import numpy as np

    from repro_torch.core import (DATASETS_GB, EmilPlatformModel,
                                  fit_emil_surrogates, paper_space)
    from repro_torch.tune import TuningSession

    platform = EmilPlatformModel()
    gb = DATASETS_GB["human"]
    t0 = time.perf_counter()
    sur, n_exp = fit_emil_surrogates(platform, gb,
                                     datasets_gb=list(DATASETS_GB.values()),
                                     seed=seed)
    fit_s = time.perf_counter() - t0
    check(n_exp == 7200, f"paper_search: {n_exp} grid experiments")

    space = paper_space()
    grid = space.index_grid()
    cols = space.enumerate_columns(grid)
    feats = torch.as_tensor(space.encode_indices(grid), dtype=torch.float32,
                            device="cuda")

    def rel_gap(got: torch.Tensor, want: np.ndarray) -> float:
        got = got.double().cpu().numpy()
        return float(np.max(np.abs(got - want) / np.abs(want)))

    gaps = {}
    for side, model, features in (
            ("host", sur.host, sur.host_features_cols),
            ("device", sur.device, sur.device_features_cols)):
        X = features(cols)
        gaps[side] = rel_gap(model.predict_fn_torch("cuda")(
            torch.as_tensor(X, device="cuda")), model.predict(X))
    energy = sur.energy_fn_torch_builder(space, "cuda")
    gaps["energy"] = rel_gap(energy(feats), sur.predict_energy_batch(cols))
    check(max(gaps.values()) <= SEARCH_PREDICT_RTOL,
          f"paper_search: card predictions off numpy's by {gaps}")

    def session(device):
        return TuningSession(space, evaluator=platform.evaluator(gb),
                             surrogate=sur, n_training_experiments=n_exp,
                             device=device)

    t0 = time.perf_counter()
    em = session("cpu").run("em")
    em_s = time.perf_counter() - t0
    runs = {}
    for device, seeds in (("cuda", SEARCH_SEEDS), ("cpu", SEARCH_CPU_SEEDS)):
        for s in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = session(device).run(
                "saml", engine="vectorized", iterations=SEARCH_ITERATIONS,
                n_chains=SEARCH_CHAINS, seed=s)
            torch.cuda.synchronize()
            runs.setdefault(device, []).append({
                "seed": s, "s": time.perf_counter() - t0,
                "predictions": res.n_predictions,
                "best_s": res.best_energy_measured,
                "over_em": res.best_energy_measured
                / em.best_energy_measured - 1,
                "best_config": res.best_config})
    for run in runs["cuda"]:
        check(run["over_em"] <= SEARCH_EM_GAP,
              f"paper_search: card SAML seed {run['seed']} lies "
              f"{100 * run['over_em']:.2f} % above EM")
    emit(phase="paper_search", ok=True, dataset_gb=gb,
         grid_experiments=n_exp, fit_s=fit_s, space_size=space.size(),
         predict_rel_gap=gaps, em_best_s=em.best_energy_measured,
         em_config=em.best_config, em_s=em_s, chains=SEARCH_CHAINS,
         iterations=SEARCH_ITERATIONS, saml_card=runs["cuda"],
         saml_cpu=runs["cpu"], cpu_threads=torch.get_num_threads())


def attention_bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    return roofline_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)


def timed_pair(kernel_fn, plain_fn, repeats: int):
    """(kernel output, plain output, kernel ms, plain ms): each warmed once,
    then timed by CUDA events, kernel first, then plain."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    ms = device_ms(kernel_fn, repeats)
    plain_ms = device_ms(plain_fn, max(1, repeats // 5))
    return got, want, ms, plain_ms


def float_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def phase_attention_parity(seed: int) -> list[dict]:
    """B3 at the prefill shape and B4 at the decode shape against their
    plain versions, plus float32 cases with TF32 off; B3 in both builds at
    hd 64 and 96 with ragged T and a q_offset, B4 at phi3-mini's hd 96
    decode shape and at hd 192."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention.ops import DEFAULTS as DA
    from repro_torch.kernels.decode_attention.ops import fit_launch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ops import DEFAULTS as FA
    from repro_torch.kernels.flash_attention.ops import F32_DEFAULTS as FA32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(LM_ARCH)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, t, s_len = LM_BATCH, LM_PROMPT, LM_PROMPT + LM_GEN
    gen = torch.Generator("cuda")
    gen.manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- B3: prefill shape, bf16, causal; gate 2e-2 (bf16 output, the
    # reference's rule for sub-4-byte floats); lse in float32 to 1e-3
    q, k, v = (randn(b, t, h, hd) for _ in range(3))
    (o, lse), (o_p, lse_p), ms, plain_ms = timed_pair(
        lambda: fak.flash_attention_fwd(q, k, v, causal=True, **FA),
        lambda: fak.flash_attention_fwd_plain(q, k, v, causal=True), 10)
    ok = (torch.allclose(o.float(), o_p.float(), atol=2e-2, rtol=2e-2)
          and torch.allclose(lse, lse_p, atol=1e-3, rtol=1e-3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    library_ms = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 10)
    elem = q.element_size()
    n_bytes = 4 * b * t * h * hd * elem + b * h * t * 4
    n_flops = 4 * b * h * hd * t * (t + 1) / 2
    bound_ms, bound_by = attention_bound(n_bytes, n_flops)
    flash = {"name": "flash_attention_fwd", "ok": ok, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
             "launches": 0, "max_abs_err": float_err(o, o_p), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    flash_case = {"shape": [b, t, h, hd], "dtype": "bfloat16",
                  "launch": dict(FA), "lse_max_abs_err": float_err(lse, lse_p),
                  "tflops": n_flops / ms / 1e9}
    del q, k, v, o, lse, o_p, lse_p, qt, kt, vt

    # float32 at a smaller shape, gate 2e-4 (the reference's float32 gate)
    q32, k32, v32 = (randn(2, 512, 4, 64, dtype=torch.float32)
                     for _ in range(3))
    o32, _ = fak.flash_attention_fwd(q32, k32, v32, causal=True, **FA32)
    o32_p, _ = fak.flash_attention_fwd_plain(q32, k32, v32, causal=True)
    f32_err = float_err(o32, o32_p)
    check(torch.allclose(o32, o32_p, atol=2e-4, rtol=2e-4),
          f"flash_attention_fwd float32: max abs err {f32_err}")
    flash_case["float32"] = {"shape": [2, 512, 4, 64], "max_abs_err": f32_err}

    # both builds at hd 64 and 96 (phi3-mini's), ragged T (a multiple of no
    # block), a decode-style q_offset and no mask: bfloat16 over launch
    # points with 16 and 32 rows a warp and ring depths 1-4 (2e-2, lse
    # 1e-3), float32 at its launch point (2e-4)
    ragged = []
    bf16_launches = ((128, 64, 128, 2), (16, 16, 32, 1), (64, 128, 128, 3),
                     (256, 256, 256, 1), (32, 32, 32, 4))
    for hd_ in (64, 96):
        for tq, tk, q_offset, causal in ((333, 333, 0, True),
                                         (77, 333, 256, True),
                                         (200, 333, 0, False)):
            for dtype in (torch.bfloat16, torch.float32):
                qr, kr, vr = (randn(2, n, 4, hd_, dtype=dtype)
                              for n in (tq, tk, tk))
                o_p, lse_p = fak.flash_attention_fwd_plain(
                    qr, kr, vr, causal=causal, q_offset=q_offset)
                tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
                launches = (bf16_launches if dtype == torch.bfloat16 else
                            (tuple(FA32[k] for k in ("block_q", "block_k",
                                                     "block_threads",
                                                     "stages")),))
                for bq, bk, nt, st in launches:
                    o, lse = fak.flash_attention_fwd(
                        qr, kr, vr, causal=causal, q_offset=q_offset,
                        block_q=bq, block_k=bk, block_threads=nt, stages=st)
                    err, lse_err = float_err(o, o_p), float_err(lse, lse_p)
                    ragged.append({"hd": hd_, "dtype": str(dtype)[6:],
                                   "tq": tq, "tk": tk, "q_offset": q_offset,
                                   "causal": causal, "launch": [bq, bk, nt, st],
                                   "max_abs_err": err,
                                   "lse_max_abs_err": lse_err})
                    check(torch.allclose(o.float(), o_p.float(), atol=tol,
                                         rtol=tol)
                          and torch.allclose(lse, lse_p, atol=1e-3, rtol=1e-3),
                          f"flash_attention_fwd ragged: {ragged[-1]}")
    flash_case["ragged"] = {
        "cases": len(ragged),
        "max_abs_err": {dt: max(r["max_abs_err"] for r in ragged
                                if r["dtype"] == dt)
                        for dt in ("bfloat16", "float32")},
        "lse_max_abs_err": max(r["lse_max_abs_err"] for r in ragged)}

    # the encoder-decoder's shapes (Whisper-base: 8 heads of 64): the
    # encoder unmasked at T 1500 and cross-attention, 448 queries over 1500
    # keys (a ragged last key block), both builds; and B3 at nemotron-4's
    # hd 192 at the wrapper's bf16 launch (fit_launch: a warp a 16-row
    # tile, 256 threads)
    from repro_torch.kernels.flash_attention.ops import fit_launch as fa_fit
    new_shapes = []
    for hd_, h_, tq, tk, causal, dtypes in (
            (64, 8, 1500, 1500, False, (torch.bfloat16, torch.float32)),
            (64, 8, 448, 1500, False, (torch.bfloat16, torch.float32)),
            (192, 4, 333, 333, True, (torch.bfloat16,))):
        for dtype in dtypes:
            qr, kr, vr = (randn(2, n, h_, hd_, dtype=dtype)
                          for n in (tq, tk, tk))
            launch = fa_fit(FA if dtype == torch.bfloat16 else FA32, dtype,
                            hd_)
            o, lse = fak.flash_attention_fwd(qr, kr, vr, causal=causal,
                                             **launch)
            o_p, lse_p = fak.flash_attention_fwd_plain(qr, kr, vr,
                                                       causal=causal)
            tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
            new_shapes.append({"hd": hd_, "dtype": str(dtype)[6:], "tq": tq,
                               "tk": tk, "causal": causal, "launch": launch,
                               "max_abs_err": float_err(o, o_p),
                               "lse_max_abs_err": float_err(lse, lse_p)})
            check(torch.allclose(o.float(), o_p.float(), atol=tol, rtol=tol)
                  and torch.allclose(lse, lse_p, atol=1e-3, rtol=1e-3),
                  f"flash_attention_fwd: {new_shapes[-1]}")
    flash_case["new_shapes"] = new_shapes
    del qr, kr, vr, o, lse, o_p, lse_p

    # -- B4: decode shape (cache S = prompt + gen), bf16 cache, float32 out;
    # one launch a call (the split combine inside); the two serving fill
    # levels and length 37, where most segments lie past `length` and must
    # weigh exactly 0; the same bits twice
    rep = h // kv
    q = randn(b, kv, rep, hd)
    k, v = randn(b, s_len, kv, hd), randn(b, s_len, kv, hd)
    cases = []
    for length in (LM_PROMPT + 1, s_len, 37):
        got, want, ms, plain_ms = timed_pair(
            lambda: dak.decode_attention(q, k, v, length, **DA),
            lambda: dak.decode_attention_plain(q, k, v, length), 50)
        same = torch.equal(got, dak.decode_attention(q, k, v, length, **DA))
        qh = q.reshape(b, h, 1, hd)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)     # (b, kv, s, hd)
        mask = (torch.arange(s_len, device="cuda") < length)[None, None, None]
        sdpa = lambda: F.scaled_dot_product_attention(      # noqa: E731
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
        sdpa()
        library_ms = device_ms(sdpa, 50)
        n_bytes = (2 * b * length * kv * hd * k.element_size()
                   + q.numel() * q.element_size() + b * h * hd * 4)
        n_flops = 4 * b * h * hd * length
        bound_ms, bound_by = attention_bound(n_bytes, n_flops)
        cases.append({"length": length, "ok": torch.allclose(
            got, want, atol=2e-4, rtol=2e-4) and same,
            "deterministic": same, "max_abs_err": float_err(got, want),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "gbytes_per_s": n_bytes / ms / 1e6})
    # the logsumexp output (the sequence-sharded decode's combine): the
    # same output bits, lse within 1e-4 of the plain version's, its time
    # beside the output-only call's
    length = s_len
    got, lse = dak.decode_attention(q, k, v, length, **DA, return_lse=True)
    want, lse_p = dak.decode_attention_plain(q, k, v, length,
                                             return_lse=True)
    lse_case = {"length": length,
                "same_out_bits": torch.equal(
                    got, dak.decode_attention(q, k, v, length, **DA)),
                "lse_max_abs_err": float_err(lse, lse_p),
                "lse_ms": device_ms(lambda: dak.decode_attention(
                    q, k, v, length, **DA, return_lse=True), 50)}
    check(lse_case["same_out_bits"]
          and torch.allclose(lse, lse_p, atol=1e-4, rtol=1e-4),
          f"decode_attention return_lse: {lse_case}")
    cases[1]["lse"] = lse_case
    full = cases[1]
    decode = {"name": "decode_attention", "ok": all(c["ok"] for c in cases),
              "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
              "replaces": "src/repro/kernels/decode_attention/kernel.py:107",
              "launches": 0,
              "max_abs_err": max(c["max_abs_err"] for c in cases),
              **{key: full[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
              "lse_ms": lse_case["lse_ms"]}
    del q, k, v

    # float32 cache at a smaller shape, gate 2e-4
    q32 = randn(2, 2, 4, 64, dtype=torch.float32)
    k32, v32 = (randn(2, 1000, 2, 64, dtype=torch.float32) for _ in range(2))
    got, lse = dak.decode_attention(q32, k32, v32, 777, **DA,
                                    return_lse=True)
    want, lse_p = dak.decode_attention_plain(q32, k32, v32, 777,
                                             return_lse=True)
    d32_err = float_err(got, want)
    check(torch.allclose(got, want, atol=2e-4, rtol=2e-4)
          and torch.allclose(lse, lse_p, atol=1e-4, rtol=1e-4)
          and torch.equal(got, dak.decode_attention(q32, k32, v32, 777,
                                                    **DA)),
          f"decode_attention float32: max abs err {d32_err}, lse "
          f"{float_err(lse, lse_p)}")

    # hd 96 at phi3-mini's decode shape (32 kv heads, rep 1, batch 8, cache
    # 2176), and hd 192 at nemotron4's grouping (8 kv heads, rep 12), bf16
    # cache, gate 2e-4 (float32 output)
    head_dims = []
    for hd_, b_, kv_, rep_, length in ((96, 8, 32, 1, LM_PROMPT + 1),
                                      (192, 1, 8, 12, 1000)):
        q = randn(b_, kv_, rep_, hd_)
        k, v = randn(b_, s_len, kv_, hd_), randn(b_, s_len, kv_, hd_)
        launch = fit_launch(DA, rep_, hd_, q.dtype)
        got = dak.decode_attention(q, k, v, length, **launch)
        want = dak.decode_attention_plain(q, k, v, length)
        head_dims.append({"shape": [b_, kv_, rep_, hd_, s_len],
                          "length": length, "launch": launch,
                          "max_abs_err": float_err(got, want),
                          "ms": device_ms(lambda: dak.decode_attention(
                              q, k, v, length, **launch), 50)})
        check(torch.allclose(got, want, atol=2e-4, rtol=2e-4),
              f"decode_attention hd {hd_}: {head_dims[-1]}")
    del q, k, v

    # cross-attention decode through the wrapper (length=None: the whole
    # cache, S 1500, a multiple of no tile; rep 1) at Whisper's shape, and
    # its self-attention cache (1628) at fill 37
    from repro_torch.kernels.decode_attention import ops as da_ops
    for s_, length in ((WHISPER_FRAMES, None),
                       (WHISPER_FRAMES + WHISPER_GEN, 37)):
        q = randn(WHISPER_BATCH, 8, 64)
        k, v = (randn(WHISPER_BATCH, s_, 8, 64) for _ in range(2))
        got = da_ops.decode_attention(q, k, v, length=length)
        want = dak.decode_attention_plain(q.reshape(WHISPER_BATCH, 8, 1, 64),
                                          k, v, s_ if length is None
                                          else length).reshape(got.shape)
        head_dims.append({"shape": [WHISPER_BATCH, 8, 1, 64, s_],
                          "length": length, "launch": "wrapper",
                          "max_abs_err": float_err(got, want),
                          "ms": device_ms(lambda: da_ops.decode_attention(
                              q, k, v, length=length), 50)})
        check(torch.allclose(got, want, atol=2e-4, rtol=2e-4),
              f"decode_attention: {head_dims[-1]}")
    del q, k, v

    emit(phase="attention_parity",
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         flash=flash_case,
         decode={"shape": [b, kv, rep, hd, s_len], "dtype": "bfloat16",
                 "launch": dict(DA), "cases": cases,
                 "float32": {"shape": [2, 2, 4, 64, 1000], "length": 777,
                             "max_abs_err": d32_err},
                 "head_dims": head_dims},
         results=[{key: r[key] for key in ("name", "ok", "max_abs_err", "ms",
                                           "plain_ms", "bound_ms",
                                           "library_ms")}
                  for r in (flash, decode)])
    for r in (flash, decode):
        check(r["ok"], f"{r['name']} disagrees with its plain version "
                       f"(max abs err {r['max_abs_err']})")
    return [flash, decode]


def lm_metas() -> dict:
    from repro_torch import configs

    cfg = configs.get(LM_ARCH)
    return {
        "flash_attention": {"bh": LM_BATCH * cfg.n_heads, "tq": LM_PROMPT,
                            "tk": LM_PROMPT, "hd": cfg.head_dim,
                            "causal": True},
        "decode_attention": {"b": LM_BATCH, "kv": cfg.n_kv_heads,
                             "rep": cfg.n_heads // cfg.n_kv_heads,
                             "hd": cfg.head_dim, "s": LM_PROMPT + LM_GEN},
    }


def phase_lm_tune(seed: int, store_path: Path) -> dict:
    from repro_torch.tune import kernels as ktune

    outs, report = {}, []
    for name, meta in lm_metas().items():
        t0 = time.perf_counter()
        out = ktune.tune_kernel(name, meta, dtype="bfloat16",
                                store=store_path, seed=seed)
        seconds = time.perf_counter() - t0
        default_s, best_s = out.default_time(), out.best_time()
        check(not out.result.from_cache, f"{name}: first tune from the cache")
        check(out.measured_fraction <= 0.05,
              f"{name}: measured {out.n_measured} of {out.space_size}")
        check(out.timer.n_launch_failed == 0,
              f"{name}: {out.timer.n_launch_failed} launches refused: "
              f"{out.timer.rejected}")
        again = ktune.tune_kernel(name, meta, dtype="bfloat16",
                                  store=store_path, seed=seed)
        check(again.result.from_cache and again.n_measured == 0,
              f"{name}: repeat was not a zero-measurement cache hit")
        check(again.best_config == out.best_config,
              f"{name}: cached config differs")
        outs[name] = out
        report.append({
            "kernel": name, "shape": meta, "seconds": round(seconds, 3),
            "space_size": out.space_size, "n_measured": out.n_measured,
            "measured_fraction": out.measured_fraction,
            "n_launch_failed": out.timer.n_launch_failed,
            "n_parity_rejected": sum("parity" in r for r in
                                     out.timer.rejected.values()),
            "default_config": out.default_config, "default_ms": default_s * 1e3,
            "best_config": out.best_config, "best_ms": best_s * 1e3,
            "best_source": out.best_source,
            "best_over_default": best_s / default_s,
            "repeat_from_cache": again.result.from_cache,
            "repeat_n_measured": again.n_measured})
        check(best_s <= default_s, f"{name}: the stored point "
                                   f"{out.best_config} is slower than the "
                                   "default it measured")
    emit(phase="lm_tune", ok=True, tunes=report)
    return outs


def phase_lm_serve(seed: int, store_path: Path, tunes: dict):
    """The LM path: its launch counters go to 0 just before
    ``serve_session`` and are read just after."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import build_model
    from repro_torch.tune import kernels as ktune

    cfg = configs.get(LM_ARCH)
    check(cfg.compute_dtype == "bfloat16", f"{LM_ARCH} computes in "
                                           f"{cfg.compute_dtype}")
    ktune.configure(store_path)
    measured = {name: tuned.timer.n_measured
                for name, tuned in tunes.items()}
    resolved = {name: ktune.resolve_config(name, meta, "bfloat16",
                                           device="cuda")
                for name, meta in lm_metas().items()}
    for name, tuned in tunes.items():
        check(resolved[name] == tuned.best_config,
              f"lm_serve: {name} resolved {resolved[name]}")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed).cast_for_serving()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    fak.flash_attention_fwd.launches = 0
    dak.decode_attention.launches = 0
    out = serve_session(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                        gen=LM_GEN, seed=seed, model=model)
    launches = {"flash_attention_fwd": fak.flash_attention_fwd.launches,
                "decode_attention": dak.decode_attention.launches}
    want = {"flash_attention_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * (LM_GEN - 1)}
    check(launches == want, f"lm_serve: launches {launches}, want {want}")
    check(all(tuned.timer.n_measured == measured[name]
              for name, tuned in tunes.items()),
          "lm_serve: serving measured new configurations")
    generated = out["generated"]
    check(generated.shape == (LM_BATCH, LM_GEN)
          and ((0 <= generated) & (generated < cfg.vocab_size)).all(),
          f"lm_serve: generated tokens {generated.shape}")
    ktune.disable()
    emit(phase="lm_serve", ok=True, arch=LM_ARCH, batch=LM_BATCH,
         prompt_len=LM_PROMPT, gen=LM_GEN, params=cfg.param_count(),
         build_s=build_s, prefill_s=out["prefill_s"],
         decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
         resolved=resolved, launches=launches,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         first_tokens=generated[:, :8].tolist())
    return model, generated, launches


def phase_lm_parity(model, generated, seed: int) -> None:
    """The same weights with the kernels and with the plain versions, on
    the card, teacher-forced on the first ``LM_PARITY_STEPS`` generated
    tokens.

    Tolerance: the largest logit difference of any step at most 5 % of
    that step's largest logit magnitude.  Both runs compute in bfloat16
    (8 mantissa bits, 0.4 % per rounding) and round each layer's attention
    output from float32 sums taken in another order, so single-ulp flips
    enter every one of the 36 residual layers; a wrong mask, position or
    cache slot instead moves the logits by their own size.
    """
    import numpy as np

    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (LM_BATCH, LM_PROMPT)), device="cuda")
    feed = torch.as_tensor(generated, device="cuda")[:, :LM_PARITY_STEPS]
    with_kernels, _, _ = teacher_forced(model, prompt, feed)
    with_plain, _, _ = teacher_forced(model, prompt, feed, plain_patches())
    rel = logit_gap(with_kernels, with_plain)
    agree = float(np.mean([
        float((a.argmax(-1) == p.argmax(-1)).float().mean())
        for a, p in zip(with_kernels, with_plain)]))
    first = with_kernels[0]
    check(bool(torch.isfinite(torch.stack(with_kernels)).all()),
          "lm_parity: non-finite logits")
    check(first.shape == (LM_BATCH, 1, model.cfg.vocab_size),
          f"lm_parity: prefill logits {tuple(first.shape)}")
    check(max(rel) <= 0.05, f"lm_parity: relative logit error {max(rel)}")
    emit(phase="lm_parity", ok=True, steps=len(rel), tolerance=0.05,
         prefill_rel_err=rel[0], decode_rel_err_max=max(rel[1:]),
         decode_rel_err_mean=float(np.mean(rel[1:])),
         argmax_agreement=agree,
         logit_abs_max=float(first.abs().max()))


# -- the LM-training path ---------------------------------------------------------

def phase_lm_requests(model, seed: int, store_path: Path,
                      tunes: dict) -> dict:
    """Request serving (A3) on the LM path's model and store: its launch
    counters go to 0 just before ``serve_requests`` and are read just
    after.  The step builder is the one ``serve_requests`` builds,
    wrapped here to count the card group's dispatches and keep one
    chunk's tokens and output; after serving, the same step runs that
    chunk again (its output must be the same bits), teacher-forced
    against the plain versions (``request_parity``), and once more under
    the profiler for the device's busy share of a step."""
    from repro_torch.core.hetero import DeviceGroup
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.launch import serve as launch
    from repro_torch.tune import kernels as ktune

    cfg = model.cfg
    ktune.configure(store_path)
    measured = {name: tuned.timer.n_measured
                for name, tuned in tunes.items()}
    step = launch._memoize_per_group(launch._stream_step_builder(
        model, prompt_len=REQ_PROMPT, gen=REQ_GEN, seed=seed))
    dispatches = []
    kept = {}

    def counted(group):
        fn = step(group)

        def run(chunk):
            handle = fn(chunk)
            dispatches.append(int(chunk["tokens"].shape[0]))
            if not kept:
                kept.update(tokens=chunk["tokens"].clone(), handle=handle)
            return handle
        return run

    group = DeviceGroup("all", [torch.device("cuda", 0)])
    fak.flash_attention_fwd.launches = 0
    dak.decode_attention.launches = 0
    t0 = time.perf_counter()
    out = launch.serve_requests(
        cfg, groups=[group], model=model, n_requests=REQ_N,
        rate_rps=REQ_RATE, prompt_len=REQ_PROMPT, gen=REQ_GEN, seed=seed,
        step_builder=counted)
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fak.flash_attention_fwd.launches,
                "decode_attention": dak.decode_attention.launches}
    want = {"flash_attention_fwd": cfg.n_layers * len(dispatches),
            "decode_attention": cfg.n_layers * (REQ_GEN - 1)
            * len(dispatches)}
    check(launches == want,
          f"lm_requests: launches {launches}, want {want}")
    check(all(tuned.timer.n_measured == measured[name]
              for name, tuned in tunes.items()),
          "lm_requests: serving measured new configurations")
    s = out["summary"]
    records = out["records"]
    rids = [r["rid"] for r in records]
    check(len(rids) == REQ_N and len(set(rids)) == REQ_N
          and s["requests"] == REQ_N
          and all(r["status"] in ("completed", "shed") for r in records),
          f"lm_requests: {len(set(rids))} of {REQ_N} requests terminal "
          f"({len(rids)} records)")
    check(s["completed"] >= 1, f"lm_requests: nothing completed ({s})")

    # the same step on the kept chunk again: the same bits
    first = kept["handle"].block_until_ready().value
    again = step(group)(
        {"tokens": kept["tokens"]}).block_until_ready().value
    check(bool(torch.equal(first, again)),
          "lm_requests: a re-run of a served chunk gave other tokens")
    check(first.shape == (kept["tokens"].shape[0], REQ_GEN)
          and bool(((first >= 0) & (first < cfg.vocab_size)).all()),
          f"lm_requests: generated tokens {tuple(first.shape)}")
    parity = request_parity(model, kept["tokens"].to("cuda"), first)
    split = device_split(
        lambda: step(group)({"tokens": kept["tokens"]}).block_until_ready())
    ktune.disable()

    completed = [r for r in records if r["status"] == "completed"]
    in_slo = [r for r in completed if r["slo_ok"]]
    by_class = {}
    for r in records:
        c = by_class.setdefault(r["klass"], {"requests": 0, "completed": 0,
                                             "slo_ok": 0})
        c["requests"] += 1
        c["completed"] += r in completed
        c["slo_ok"] += r in in_slo
    emit(phase="lm_requests", ok=True, arch=cfg.name, requests=REQ_N,
         rate_rps=REQ_RATE, prompt_len=REQ_PROMPT, gen=REQ_GEN,
         wall_s=wall_s, dispatches=len(dispatches),
         rows_a_dispatch=[min(dispatches), max(dispatches)]
         if dispatches else None,
         steps=s["steps"], completed=s["completed"], shed=s["shed"],
         shed_rate=s["shed_rate"], shed_reasons=s["shed_reasons"],
         slo_violations=s["slo_violations"],
         slo_attainment=len(in_slo) / REQ_N,
         by_class=by_class,
         goodput_rows_per_s=s.get("goodput_rows_per_s"),
         tokens_per_s=s.get("tokens_per_s"),
         e2e_s={q: s.get(f"e2e_{q}") for q in ("p50", "p95", "p99")},
         queue_delay_s={q: s.get(f"queue_delay_{q}")
                        for q in ("p50", "p95")},
         service_s={q: s.get(f"service_{q}") for q in ("p50", "p95")},
         service_first_s=min(completed, key=lambda r: r["t_done"])[
             "service_s"] if completed else None,
         launches=launches, step_split=split,
         rerun_rows=int(kept["tokens"].shape[0]),
         first_tokens=first[:, :8].tolist(), parity=parity)
    return launches


def request_parity(model, prompt, generated) -> dict:
    """One served chunk teacher-forced on its own tokens, with the kernels
    at the launches the request path resolves and with the plain versions.

    Every B3 and B4 call of the kernels' run is held against its plain
    version on the same inputs (B3 2e-2 in bf16, its lse 1e-3; B4 2e-4,
    float32 out: ``attention_parity``'s gates), and the logits of the two
    runs against each other (``lm_parity``'s 5 %)."""
    import numpy as np
    from unittest import mock

    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ops as fa_ops

    seen = {"flash_attention_fwd": [], "decode_attention": []}

    def checked_fwd(q, k, v, *, causal, q_offset, **launch):
        o, lse = fak.flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=q_offset, **launch)
        o_p, lse_p = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   q_offset=q_offset)
        seen["flash_attention_fwd"].append({
            "shape": list(q.shape), "tk": k.shape[1], "launch": launch,
            "max_abs_err": float_err(o, o_p),
            "lse_max_abs_err": float_err(lse, lse_p),
            "ok": torch.allclose(o.float(), o_p.float(), atol=2e-2, rtol=2e-2)
            and torch.allclose(lse, lse_p, atol=1e-3, rtol=1e-3)})
        return o, lse

    def checked_decode(q, k, v, length, **launch):
        got = dak.decode_attention(q, k, v, length, **launch)
        want = dak.decode_attention_plain(q, k, v, length)
        seen["decode_attention"].append({
            "shape": list(q.shape), "cache": k.shape[1], "length": length,
            "launch": launch, "max_abs_err": float_err(got, want),
            "ok": torch.allclose(got, want, atol=2e-4, rtol=2e-4)})
        return got

    with_kernels, _, _ = teacher_forced(model, prompt, generated, [
        mock.patch.object(fa_ops, "flash_attention_fwd", checked_fwd),
        mock.patch.object(da_ops, "decode_attention_kernel",
                          checked_decode)])
    with_plain, _, _ = teacher_forced(model, prompt, generated,
                                      plain_patches())
    n = model.cfg.n_layers
    check(len(seen["flash_attention_fwd"]) == n
          and len(seen["decode_attention"]) == n * (generated.shape[1] - 1),
          f"lm_requests: the teacher-forced chunk made "
          f"{ {k: len(v) for k, v in seen.items()} } kernel calls")
    for name, calls in seen.items():
        bad = [c for c in calls if not c["ok"]]
        check(not bad, f"lm_requests: {name} disagrees with its plain "
                       f"version in {len(bad)} of {len(calls)} calls, "
                       f"first {bad[:1]}")
    rel = logit_gap(with_kernels, with_plain)
    check(bool(torch.isfinite(torch.stack(with_kernels)).all()),
          "lm_requests: non-finite logits")
    check(max(rel) <= 0.05, f"lm_requests: relative logit error {max(rel)}")
    served = float(np.mean([
        float((step[:, -1].argmax(-1) == generated[:, i]).float().mean())
        for i, step in enumerate(with_kernels)]))
    fwd, dec = seen["flash_attention_fwd"], seen["decode_attention"]
    return {"tolerance": 0.05, "prefill_rel_err": rel[0],
            "decode_rel_err_max": max(rel[1:]),
            "argmax_agreement": float(np.mean([
                float((a.argmax(-1) == p.argmax(-1)).float().mean())
                for a, p in zip(with_kernels, with_plain)])),
            "served_argmax_agreement": served,
            "flash_attention_fwd": {
                "calls": len(fwd), "shape": fwd[0]["shape"],
                "launch": fwd[0]["launch"],
                "max_abs_err": max(c["max_abs_err"] for c in fwd),
                "lse_max_abs_err": max(c["lse_max_abs_err"] for c in fwd)},
            "decode_attention": {
                "calls": len(dec), "shape": dec[0]["shape"],
                "cache": dec[0]["cache"],
                "lengths": [min(c["length"] for c in dec),
                            max(c["length"] for c in dec)],
                "launch": dec[0]["launch"],
                "max_abs_err": max(c["max_abs_err"] for c in dec)}}


def grad_err(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_train_attention_parity(seed: int) -> dict:
    """B5 at the training shape (bf16) against its plain version, plus
    float32 cases with TF32 off; both builds at hd 64, 96 and 128 with
    ragged T, a q_offset and no mask; bf16 within 2e-2 and float32 within
    2e-4 of the largest |grad|, and every bf16 case twice with the same
    bits."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ops import BWD_DEFAULTS as BWD
    from repro_torch.kernels.flash_attention.ops import \
        BWD_F32_DEFAULTS as BWD32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(LM_ARCH)
    b, t, h, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.head_dim
    gen = torch.Generator("cuda")
    gen.manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def case(tq, tk, q_offset, causal, dtype, launch, hd=hd, h=h, fwd=None):
        q, do = (randn(b, tq, h, hd, dtype=dtype) for _ in range(2))
        k, v = (randn(b, tk, h, hd, dtype=dtype) for _ in range(2))
        # the forward at its build's launch point (or ``fwd``)
        o, lse = fak.flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=q_offset, **(fwd or {}))
        args = (q, k, v, o, lse, do)
        kw = dict(causal=causal, q_offset=q_offset)
        return args, (lambda: fak.flash_attention_bwd(*args, **kw, **launch),
                      lambda: fak.flash_attention_bwd_plain(*args, **kw))

    # -- the training shape, bf16, causal, the defaults
    args, (kernel_fn, plain_fn) = case(t, t, 0, True, torch.bfloat16, BWD)
    got, want, ms, plain_ms = timed_pair(kernel_fn, plain_fn, 5)
    errs = {n: grad_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 want)}
    abs_err = max(float_err(g, w) for g, w in zip(got, want))
    again = kernel_fn()
    deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
    q, k, v, o, lse, do = args
    delta_ms = device_ms(lambda: fak._delta(o, do), 10)
    del again, want, got
    # SDPA's backward alone, as a yardstick (the port never calls it)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    library_ms = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    del out, qt, kt, vt, dot
    elem = q.element_size()
    # q, k, v, o, do and lse read once; dq, dk, dv written once
    n_bytes = 8 * b * t * h * hd * elem + b * h * t * 4
    n_flops = 5 * 2 * b * h * hd * t * (t + 1) / 2
    bound_ms, bound_by = attention_bound(n_bytes, n_flops)
    record = {"name": "flash_attention_bwd", "ok": max(errs.values()) <= 2e-2,
              "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:180",
              "launches": 0, "max_abs_err": abs_err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms}
    del args, q, k, v, o, lse, do
    report = {"shape": [b, t, h, hd], "dtype": "bfloat16",
              "launch": dict(BWD), "rel_err": errs, "delta_ms": delta_ms,
              "deterministic": deterministic,
              # the two programs recompute s and dp: seven products
              "bound_7_products_ms": bound_ms * 7 / 5,
              "tflops_5_products": n_flops / ms / 1e9,
              "tflops_7_products": n_flops * 7 / 5 / ms / 1e9}

    # float32 (TF32 off: the kernel never uses the tensor cores) and bf16
    # at hd 64, 96 and 128, ragged shapes, a q_offset, no mask, and other
    # launch shapes; each bf16 case run twice must give the same bits
    cases = []
    small = dict(block_q=16, block_k=16, block_threads=32)
    mid = dict(block_q=64, block_k=64, block_threads=128)
    # float32 at the training model's heads, T 512
    _, (kernel_fn, plain_fn) = case(512, 512, 0, True, torch.float32, BWD32)
    got = kernel_fn()
    err = max(grad_err(g, w) for g, w in zip(got, plain_fn()))
    cases.append({"hd": hd, "tq": 512, "tk": 512, "q_offset": 0,
                  "causal": True, "dtype": "float32",
                  "launch": [BWD32[k] for k in ("block_q", "block_k",
                                                "block_threads")],
                  "rel_err": err, "tol": 2e-4, "same_bits_twice": all(
                      torch.equal(a, g) for a, g in zip(kernel_fn(), got))})
    check(err <= 2e-4 and cases[-1]["same_bits_twice"],
          f"flash_attention_bwd: {cases[-1]}")
    for hd_, launches in ((128, ((torch.float32, BWD32),
                                 (torch.float32, dict(block_q=16, block_k=32,
                                                      block_threads=128)),
                                 (torch.bfloat16, BWD),
                                 (torch.bfloat16, small))),
                          (96, ((torch.float32, BWD32), (torch.bfloat16, BWD),
                                (torch.bfloat16, mid))),
                          (64, ((torch.float32, BWD32), (torch.bfloat16, BWD),
                                (torch.bfloat16, small)))):
        for tq, tk, q_offset, causal in ((333, 333, 0, True),
                                         (77, 333, 256, True),
                                         (200, 333, 0, False)):
            for dtype, launch in launches:
                _, (kernel_fn, plain_fn) = case(tq, tk, q_offset, causal,
                                                dtype, launch, hd=hd_, h=4)
                got, want = kernel_fn(), plain_fn()
                err = max(grad_err(g, w) for g, w in zip(got, want))
                same = all(torch.equal(a, g) for a, g in zip(kernel_fn(), got))
                tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
                cases.append({"hd": hd_, "tq": tq, "tk": tk,
                              "q_offset": q_offset, "causal": causal,
                              "dtype": str(dtype)[6:],
                              "launch": [launch[k] for k in (
                                  "block_q", "block_k", "block_threads")],
                              "rel_err": err, "tol": tol,
                              "same_bits_twice": same})
                check(err <= tol and same, f"flash_attention_bwd: {cases[-1]}")
    # Whisper's cross-attention, 448 queries over 1500 keys unmasked, 8
    # heads of 64, both builds at their defaults
    for dtype, launch in ((torch.bfloat16, BWD), (torch.float32, BWD32)):
        _, (kernel_fn, plain_fn) = case(448, 1500, 0, False, dtype, launch,
                                        hd=64, h=8)
        got, want = kernel_fn(), plain_fn()
        err = max(grad_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(a, g) for a, g in zip(kernel_fn(), got))
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        cases.append({"hd": 64, "tq": 448, "tk": 1500, "q_offset": 0,
                      "causal": False, "dtype": str(dtype)[6:],
                      "launch": [launch[k] for k in (
                          "block_q", "block_k", "block_threads")],
                      "rel_err": err, "tol": tol, "same_bits_twice": same})
        check(err <= tol and same, f"flash_attention_bwd: {cases[-1]}")
    # C6: bf16 at hd 192 (nemotron4's head size), at the wrapper's launch
    # point (fit_bwd_launch: 64 x 64): dq stages its do rows, dk/dv runs as
    # dv and dk halves of one grid; ragged T, a q_offset, no mask, and the
    # launch counts of each call exact (one of each program)
    fwd192 = {"block_q": 64, "block_k": 64}
    launch192 = fak.fit_bwd_launch(torch.bfloat16, 192)
    for tq, tk, q_offset, causal in ((333, 333, 0, True), (77, 333, 256, True),
                                     (200, 333, 0, False)):
        _, (kernel_fn, plain_fn) = case(tq, tk, q_offset, causal,
                                        torch.bfloat16, {}, hd=192, h=4,
                                        fwd=fwd192)
        before = (fak.flash_attention_bwd.launches,
                  dict(fak.flash_attention_bwd.program_launches))
        got = kernel_fn()
        after = (fak.flash_attention_bwd.launches,
                 dict(fak.flash_attention_bwd.program_launches))
        check(after == (before[0] + 1, {p_: n + 1 for p_, n in
                                        before[1].items()}),
              f"flash_attention_bwd hd 192: launches {before} -> {after}")
        want = plain_fn()
        err = max(grad_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(a, g) for a, g in zip(kernel_fn(), got))
        cases.append({"hd": 192, "tq": tq, "tk": tk, "q_offset": q_offset,
                      "causal": causal, "dtype": "bfloat16",
                      "launch": [launch192[k] for k in (
                          "block_q", "block_k", "block_threads")],
                      "rel_err": err, "tol": 2e-2, "same_bits_twice": same})
        check(err <= 2e-2 and same, f"flash_attention_bwd: {cases[-1]}")
    # its time at a training shape: batch 2 x 2048, 8 heads of 192
    args, (kernel_fn, plain_fn) = case(t, t, 0, True, torch.bfloat16, {},
                                       hd=192, h=8, fwd=fwd192)
    got, want, ms192, plain192 = timed_pair(kernel_fn, plain_fn, 5)
    n_flops = 5 * 2 * b * 8 * 192 * t * (t + 1) / 2
    n_bytes = 8 * b * t * 8 * 192 * 2 + b * 8 * t * 4
    bound192, bound192_by = attention_bound(n_bytes, n_flops)
    report["hd192"] = {
        "shape": [b, t, 8, 192], "launch": launch192, "ms": ms192,
        "plain_ms": plain192, "bound_ms": bound192, "bound_by": bound192_by,
        "rel_err": max(grad_err(g, w) for g, w in zip(got, want))}
    check(report["hd192"]["rel_err"] <= 2e-2,
          f"flash_attention_bwd hd 192: {report['hd192']}")
    del args, got, want
    report["cases"] = {
        "n": len(cases),
        "rel_err_max": {dt: max(c["rel_err"] for c in cases
                                if c["dtype"] == dt)
                        for dt in ("bfloat16", "float32")},
        "all_same_bits_twice": all(c["same_bits_twice"] for c in cases)}
    emit(phase="train_attention_parity",
         allow_tf32=torch.backends.cuda.matmul.allow_tf32, flash_bwd=report,
         result={key: record[key] for key in ("name", "ok", "max_abs_err",
                                              "ms", "plain_ms", "bound_ms",
                                              "library_ms")})
    check(record["ok"], f"flash_attention_bwd disagrees with its plain "
                        f"version: {errs}")
    check(deterministic, "flash_attention_bwd: two runs gave other bits")
    return record


def train_batch(cfg, seed: int, step: int = 0, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ) -> dict:
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.train import make_data_cfg

    data = SyntheticPipeline(make_data_cfg(cfg, batch, seq, seed))
    return {k: torch.as_tensor(v, device="cuda")
            for k, v in data.batch_at(step).items()}


# the relative L2 gate of each parameter's gradient, kernels against plain
# versions.  The key biases are reported apart: a key bias's gradient is the
# sum of its keys' gradients, which nearly cancels (a shift shared by every
# key of a query cancels in the softmax; RoPE leaves a remainder), so bf16
# rounding is a larger share of it than of any other leaf's.
KEY_BIAS = "mixer.bk"
GRAD_GATE = 0.05


# the float32 scores the plain forward materialises at once, at most: it
# runs in slices of heads beyond (nemotron-4's 96 heads at batch 8 x 2048
# would take 12 GiB, twice over, beside 30 GiB of weights)
PLAIN_SCORE_BYTES = 2 ** 31


def plain_attention_fwd(q, k, v, *, causal, q_offset, **launch):
    """B3's plain version, in slices of heads whose float32 scores stay
    within ``PLAIN_SCORE_BYTES`` (each head's attention is its own)."""
    from repro_torch.kernels.flash_attention import kernel as fak

    b, tq, h, _ = q.shape
    step = max(1, PLAIN_SCORE_BYTES // (4 * b * tq * k.shape[1]))
    if step >= h:
        return fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             q_offset=q_offset)
    outs = [fak.flash_attention_fwd_plain(
        q[:, :, i:i + step], k[:, :, i:i + step], v[:, :, i:i + step],
        causal=causal, q_offset=q_offset) for i in range(0, h, step)]
    return (torch.cat([o for o, _ in outs], dim=2),
            torch.cat([lse for _, lse in outs], dim=1))


def plain_attention_bwd(q, k, v, o, lse, do, *, causal, q_offset, **launch):
    from repro_torch.kernels.flash_attention import kernel as fak

    return fak.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         q_offset=q_offset)


def lm_grads(model, batch, fwd=None, bwd=None):
    """One loss-and-gradient pass (each layer recomputed) through the
    attention kernels, or through ``fwd``/``bwd`` patched in their place."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops

    with contextlib.ExitStack() as stack:
        for name, fn in (("flash_attention_fwd", fwd),
                         ("flash_attention_bwd", bwd)):
            if fn is not None:
                stack.enter_context(mock.patch.object(fa_ops, name, fn))
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, remat=True)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def grad_gaps(grads, want) -> dict:
    """Each parameter's gradient against ``want``'s by relative L2: the
    three worst key biases and the three worst other leaves, the largest
    of each group, and the mean over all."""
    rel = sorted(((n, float((grads[n].float() - want[n].float()).norm()
                            / want[n].float().norm().clamp_min(1e-30)))
                  for n in grads), key=lambda kv: -kv[1])
    worst = {"key_bias": [kv for kv in rel if kv[0].endswith(KEY_BIAS)][:3],
             "other": [kv for kv in rel if not kv[0].endswith(KEY_BIAS)][:3]}
    return {"max": {g: kvs[0][1] for g, kvs in worst.items() if kvs},
            "worst": worst, "mean": sum(v for _, v in rel) / len(rel)}


def phase_lm_train_parity(seed: int, controls: dict | None = None):
    """One loss-and-gradient pass at full width with the kernels, one with
    the plain versions patched in; the loss within 1 % and each
    parameter's gradient within ``GRAD_GATE`` relative L2 (bf16 compute
    through 36 layers; a wrong mask, scale or dk/dv swap moves a gradient
    by its own size).  Each of ``controls`` (name -> a wrong backward) is
    run as well, and its gaps reported beside whether the gates catch it.
    Returns the model, still without optimizer state, and the report."""
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = train_batch(cfg, seed)

    loss_k, grads_k = lm_grads(model, batch)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    loss_p, grads_p = lm_grads(model, batch, plain_attention_fwd,
                               plain_attention_bwd)
    gaps = grad_gaps(grads_k, grads_p)
    del grads_k
    loss_rel = float((loss_k - loss_p).abs() / loss_p.abs())
    report = {"seed": seed, "loss_kernels": float(loss_k),
              "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
              "grad_rel_l2_max": gaps["max"],
              "grad_rel_l2_worst": gaps["worst"],
              "grad_rel_l2_mean": gaps["mean"], "tolerance": GRAD_GATE}
    if controls:
        report["controls"] = {}
        for name, bwd in controls.items():
            _, grads_c = lm_grads(model, batch, bwd=bwd)
            caught = grad_gaps(grads_c, grads_p)
            del grads_c
            report["controls"][name] = {
                "grad_rel_l2_max": caught["max"],
                "caught": max(caught["max"].values()) > GRAD_GATE}
    del grads_p
    torch.cuda.empty_cache()
    emit(phase="lm_train_parity", ok=True, arch=LM_ARCH,
         params=sum(p.numel() for p in model.parameters()),
         build_s=build_s, **report)
    check(finite and bool(torch.isfinite(loss_k)),
          "lm_train_parity: non-finite loss or gradient")
    check(loss_rel <= 0.01, f"lm_train_parity: loss {float(loss_k)} vs "
                            f"{float(loss_p)}")
    check(max(gaps["max"].values()) <= GRAD_GATE,
          f"lm_train_parity: gradients {gaps}")
    return model, report


# kernel names of cuBLAS's matrix products on the card
MATMUL_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "sm90_", "cublas")


def kernel_kind(name: str) -> str:
    """The kind a card kernel belongs to in a device-time split."""
    low = name.lower()
    if "state_map_vec_kernel" in low or "state_map_gather_kernel" in low:
        return "dna_state_map (B1)"
    if "count_hits_kernel" in low:
        return "dna_count_hits (B2)"
    if "flash_fwd" in low:
        return "flash_attention_fwd (B3)"
    if "flash_bwd" in low:
        return "flash_attention_bwd (B5)"
    if "decode_bf16_kernel" in low or "decode_f32_kernel" in low:
        return "decode_attention (B4)"
    if "scan_bwd_summaries_kernel" in low or "scan_bwd_carry_kernel" in low \
            or "scan_bwd_chunks_kernel" in low:
        return "selective_scan_bwd (B7)"
    if "wkv_bwd_scans_kernel" in low or "wkv_bwd_chunks_kernel" in low:
        return "wkv6_bwd (B9)"
    if "scan_fwd_kernel" in low:
        return "selective_scan (B6)"
    if "wkv_serial_kernel" in low or "wkv_fwd_states_kernel" in low:
        return "wkv6 (B8)"
    if any(mark in low for mark in MATMUL_MARKS):
        return "matmul (cuBLAS)"
    return "other"


def device_time_us(evt, total: bool = False) -> float:
    """A profiler event's device time, self or with its children, under
    either of the attribute names torch releases use."""
    attrs = (("device_time_total", "cuda_time_total") if total else
             ("self_device_time_total", "self_cuda_time_total"))
    for attr in attrs:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_split(fn, trace: Path | None = None, ranges: tuple = ()) -> dict:
    """``fn`` once under ``torch.profiler``: the card's kernel time by
    ``kernel_kind`` against the wall time, the device time of the host
    range ``adamw`` (the optimizer) taken out of "other" where the trace
    has one, the number of device activities (kernels and copies) and the
    longest kernels.  The device time under each host range of ``ranges``
    (``record_function`` names) is reported apart, in ``ranges_ms``: its
    kernels stay in their kinds.  ``trace`` receives the Chrome trace.

    The trace is read from its raw events, as the profiler's own parse
    links them: a device activity belongs to the host events whose
    correlation id is its linked one (the op, or the runtime call, that
    launched it), and to a host range once where one of them starts
    inside the range on the same thread.  ``key_averages()`` builds every
    host op's event tree first (~10 s for a step of 20,000 launches) and
    counts an activity once for each host event of its id: host events
    share ids (an op and a runtime call beside it), so a range read that
    way can hold more than the card did (``scripts/torch_split_check.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    spans: dict = {name: [] for name in (*ranges, "adamw")}
    launched_by: dict = {}          # host correlation id -> [(thread, ns)]
    activities = []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CPU:
            if evt.name() in spans:
                spans[evt.name()].append((evt.start_thread_id(),
                                          evt.start_ns(), evt.end_ns()))
            elif evt.linked_correlation_id() == 0:
                launched_by.setdefault(evt.correlation_id(), []).append(
                    (evt.start_thread_id(), evt.start_ns()))
        elif evt.name() not in spans and evt.duration_ns() > 0:
            # the ranges' own device-side copies are not activities
            activities.append(evt)
    for found in spans.values():
        found.sort()

    def inside(found: list, host: tuple) -> bool:
        i = bisect.bisect_right(found, (host[0], host[1], math.inf)) - 1
        return i >= 0 and found[i][0] == host[0] and found[i][2] >= host[1]

    by_name: dict = {}
    in_range = {name: 0.0 for name in spans}
    for evt in activities:
        us = evt.duration_ns() / 1e3
        row = by_name.setdefault(evt.name(), [0.0, 0])
        row[0] += us
        row[1] += 1
        hosts = launched_by.get(evt.linked_correlation_id(), ())
        for name, found in spans.items():
            if any(inside(found, host) for host in hosts):
                in_range[name] += us
    split: dict = {}
    top = []
    launches = 0
    for name, (us, count) in by_name.items():
        kind = kernel_kind(name)
        split[kind] = split.get(kind, 0.0) + us / 1e3
        launches += count
        top.append((us / 1e3, count, name[:90]))
    ranges_ms = {name: in_range[name] / 1e3 if spans[name]
                 else "not measured" for name in ranges}
    adamw_ms = in_range["adamw"] / 1e3 if spans["adamw"] else None
    busy = sum(split.values())
    if adamw_ms is not None:
        if 0 < adamw_ms <= split.get("other", 0.0):
            split["AdamW"] = adamw_ms
            split["other"] -= adamw_ms
        else:
            split["AdamW"] = "not measured (inside other)"
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy if busy > 0 else "not measured",
           "idle_share": 1 - busy / wall_ms if busy > 0 else "not measured",
           "device_launches": launches, "split_ms": split,
           "top": sorted(top, reverse=True)[:12]}
    if ranges:
        out["ranges_ms"] = ranges_ms
    return out


def phase_lm_train(model, seed: int) -> dict:
    """The training path: its launch counters go to 0 just before
    ``train_loop`` and are read just after."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import AdamWConfig, warmup_cosine

    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    bwd = fak.flash_attention_bwd
    fak.flash_attention_fwd.launches = 0
    bwd.launches = 0
    bwd.program_launches = {"dq": 0, "dkv": 0}
    out = train_loop(cfg, steps_total=TRAIN_STEPS, batch=TRAIN_BATCH,
                     seq_len=TRAIN_SEQ, seed=seed, remat=True, log_every=0,
                     model=model)
    launches = {"flash_attention_fwd": fak.flash_attention_fwd.launches,
                "flash_attention_bwd": bwd.launches,
                "flash_attention_bwd_dq": bwd.program_launches["dq"],
                "flash_attention_bwd_dkv": bwd.program_launches["dkv"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n = cfg.n_layers * TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * n, "flash_attention_bwd": n,
            "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n}
    losses = out["losses"]
    warm = sorted(out["step_seconds"][1:])
    warm_s = warm[len(warm) // 2]

    # one more warm step, outside the counted run, under the profiler
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 20, TRAIN_STEPS))
    batch = train_batch(cfg, seed, TRAIN_STEPS)
    split = device_split(lambda: train_step(model, out["state"]["opt"], batch,
                                            opt_cfg, remat=True))
    emit(phase="lm_train", ok=True, arch=LM_ARCH, batch=TRAIN_BATCH,
         seq_len=TRAIN_SEQ, steps=TRAIN_STEPS, remat=True,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         losses=losses, ln_vocab=math.log(cfg.vocab_size),
         step_seconds=out["step_seconds"], warm_step_s=warm_s,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / warm_s, launches=launches,
         peak_gib=peak_gib, profiled_step=split)
    check(launches == want, f"lm_train: launches {launches}, want {want}")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"lm_train: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"lm_train: first loss {losses[0]}, ln V {math.log(cfg.vocab_size)}")
    return launches


# the save_dots path's gates: the two steps' losses, each gradient against
# full remat's (relative L2), the dry run's peak against the card's
SAVE_DOTS_LOSS_RTOL, SAVE_DOTS_GRAD_GATE, DRYRUN_PEAK_RTOL = 1e-3, 1e-2, 0.10


def phase_save_dots_train(seed: int) -> dict:
    """``remat="save_dots"`` at full width (A7), against full remat and
    against its dry run.

    Qwen2.5-3B built from ``seed`` (float32 parameters, bf16 compute) at
    ``lm_train``'s shape.  First one gradient pass under each policy on
    the same weights (``loss_and_grads``; the ``save_dots`` pass with
    every B3/B5 call held against its plain version); then, for each
    policy, the model built again from the seed takes one ``train_step``
    with zero AdamW moments, its launch counters at 0 just before and
    read just after, its peak from ``reset_peak_memory_stats``, then a
    warm step on the host clock and one under the profiler.  Then the
    same step on meta tensors (``make_train_step(...).dry_run()``, no
    card): its peak reckoned within ``DRYRUN_PEAK_RTOL`` of the card's and
    its kernel census equal to the card's launches by program.  Returns
    the ``save_dots`` step's launches."""
    from repro_torch import configs
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.launch.steps import (loss_and_grads, make_train_step,
                                          train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import init_opt_state

    cfg = configs.get(LM_ARCH)
    opt_cfg = AdamWConfig()
    batch = train_batch(cfg, seed)
    n = cfg.n_layers
    want = {"flash_attention_fwd": {"fwd": 2 * n},
            "flash_attention_bwd": {"dq": n, "dkv": n}}
    policies = (True, "save_dots")

    # the gradient passes, on the same weights
    model = build_model(cfg, seed=seed)
    seen: dict = {}
    loss_full, grads_full, _ = loss_and_grads(model, batch, remat=True)
    with contextlib.ExitStack() as stack:
        for patch in checked_attention(seen):
            stack.enter_context(patch)
        loss_dots, grads_dots, _ = loss_and_grads(model, batch,
                                                  remat="save_dots")
    calls = summarize_calls(seen, "save_dots_train")
    rel = {name: float((grads_dots[name].float() - g.float()).norm()
                       / g.float().norm().clamp_min(1e-30))
           for name, g in grads_full.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_dots.values())
    del grads_full, grads_dots, model
    torch.cuda.empty_cache()

    steps, counted = {}, {}
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    for remat in policies:
        key = "save_dots" if remat == "save_dots" else "full"
        model = build_model(cfg, seed=seed)
        opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
        bwd = fak.flash_attention_bwd
        fak.flash_attention_fwd.launches = 0
        bwd.launches = 0
        bwd.program_launches = {"dq": 0, "dkv": 0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = train_step(model, opt, batch, opt_cfg, remat=remat)
        loss = float(out["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {"flash_attention_fwd": {
            "fwd": fak.flash_attention_fwd.launches},
            "flash_attention_bwd": dict(bwd.program_launches)}
        counted[key] = {
            "flash_attention_fwd": fak.flash_attention_fwd.launches,
            "flash_attention_bwd": bwd.launches}
        # a warm step on the host clock, then one under the profiler
        t0 = time.perf_counter()
        float(train_step(model, opt, batch, opt_cfg, remat=remat)["loss"])
        warm_s = time.perf_counter() - t0
        split = device_split(lambda: train_step(model, opt, batch, opt_cfg,
                                                remat=remat))
        del model, opt, out
        torch.cuda.empty_cache()
        # the same step on meta tensors
        scfg = ShardingConfig(remat=True, remat_policy=key)
        dry = make_train_step(cfg, scfg, None, opt_cfg,
                              meta_batch).dry_run()
        census = {name: k["programs"] for name, k in dry["kernels"].items()}
        steps[key] = {
            "loss": loss, "step_s": step_s, "warm_step_s": warm_s,
            "profiled_step": split, "peak_gib": peak / 2 ** 30,
            "resident_gib": resident / 2 ** 30, "launches": launches,
            "dryrun": {"peak_gib": dry["peak_bytes"] / 2 ** 30,
                       "resident_gib": dry["resident_bytes"] / 2 ** 30,
                       "peak_rel_err": (dry["peak_bytes"] - peak) / peak,
                       "census": census, "seconds": dry["seconds"],
                       "torch_flops": dry["torch_flops"],
                       "kernel_flops": dry["kernel_flops"]}}
        check(launches == want, f"save_dots_train: {key} step launches "
                                f"{launches}, want {want}")
        check(census == want, f"save_dots_train: {key} dry-run census "
                              f"{census}, the card launched {launches}")
        check(abs(dry["peak_bytes"] - peak) <= DRYRUN_PEAK_RTOL * peak,
              f"save_dots_train: {key} dry-run peak "
              f"{dry['peak_bytes'] / 2 ** 30:.3f} GiB, the card's "
              f"{peak / 2 ** 30:.3f} GiB")
    loss_rel = abs(steps["save_dots"]["loss"] - steps["full"]["loss"]) \
        / abs(steps["full"]["loss"])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    emit(phase="save_dots_train", ok=True, arch=LM_ARCH, batch=TRAIN_BATCH,
         seq_len=TRAIN_SEQ, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, steps=steps,
         grad_pass_losses={"full": float(loss_full),
                           "save_dots": float(loss_dots)},
         loss_rel_err=loss_rel, grad_rel_l2_max=worst[0][1],
         grad_rel_l2_worst=worst, grad_gate=SAVE_DOTS_GRAD_GATE,
         checked_calls=calls, dryrun_peak_rtol=DRYRUN_PEAK_RTOL)
    check(finite, "save_dots_train: non-finite gradient")
    check(loss_rel <= SAVE_DOTS_LOSS_RTOL and abs(
        float(loss_dots) - float(loss_full)) <= SAVE_DOTS_LOSS_RTOL
        * abs(float(loss_full)), f"save_dots_train: losses {steps}")
    check(worst[0][1] <= SAVE_DOTS_GRAD_GATE,
          f"save_dots_train: gradients {worst}")
    check(steps["save_dots"]["dryrun"]["torch_flops"]
          < steps["full"]["dryrun"]["torch_flops"],
          "save_dots_train: save_dots recomputes no fewer products")
    return counted["save_dots"]


def phase_train_restart(seed: int) -> None:
    """The restart drill on the card at the smoke configs of Qwen2.5-3B
    (B3/B5) and RWKV-6 1.6B (B8/B9): a failure at step 7, checkpoints
    every 4 steps, resumed from step 4, bitwise equal to an uninterrupted
    run, under deterministic algorithms (the backward kernels write every
    element from one thread, with no atomics)."""
    from repro_torch import configs
    from repro_torch.dist import run_with_restarts
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.launch.train import train_loop

    for arch in (LM_ARCH, RWKV_ARCH):
        cfg = configs.get(arch).smoke()
        kw = dict(steps_total=12, batch=4, seq_len=32, ckpt_every=4,
                  log_every=0, seed=seed, device="cuda")
        bwd = {"flash_attention_bwd": fak.flash_attention_bwd,
               "wkv6_bwd": wkk.wkv6_bwd}
        before = {name: fn.launches for name, fn in bwd.items()}
        torch.use_deterministic_algorithms(True)
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
                clean = train_loop(cfg, ckpt_dir=Path(tmp) / "clean", **kw)
                report = run_with_restarts(train_loop, cfg=cfg,
                                           ckpt_dir=Path(tmp) / "restart",
                                           fail_at_step=7, **kw)
        finally:
            torch.use_deterministic_algorithms(False)
        got, want = report.result["state"]["params"], clean["state"]["params"]
        differ = [n for n in want if not torch.equal(got[n], want[n])]
        emit(phase="train_restart", ok=True, arch=cfg.name,
             attempts=report.attempts, failures=report.failures,
             resumed_from=report.result["resumed_from"],
             params_differing=differ, losses=clean["losses"],
             resumed_losses=report.result["losses"],
             bwd_launches={name: fn.launches - before[name]
                           for name, fn in bwd.items()})
        check(report.attempts == 2 and report.result["resumed_from"] == 4,
              f"train_restart {arch}: attempts {report.attempts}, resumed "
              f"from {report.result['resumed_from']}")
        check(not differ, f"train_restart {arch}: parameters differ: "
                          f"{differ[:5]}")
        check(report.result["losses"] == clean["losses"][4:],
              f"train_restart {arch}: losses after the restart differ")
        name = "wkv6_bwd" if arch == RWKV_ARCH else "flash_attention_bwd"
        check(bwd[name].launches > before[name],
              f"train_restart {arch}: {name} never ran")


# -- the recurrent serving paths (RWKV-6, Jamba) ---------------------------------

def scan_gate(got, want) -> tuple[bool, float]:
    """float32 within atol 2e-4 / rtol 2e-3 (the reference's scan gate),
    every output; returns (ok, max abs err)."""
    ok = all(torch.allclose(g, w, atol=2e-4, rtol=2e-3)
             for g, w in zip(got, want))
    return ok, max(float_err(g, w) for g, w in zip(got, want))


def ssm_metas() -> dict:
    from repro_torch import configs

    rwkv, jamba = configs.get(RWKV_ARCH), configs.get(JAMBA_ARCH)
    return {
        "rwkv6_wkv": {"b": SSM_BATCH, "t": SSM_PROMPT,
                      "h": rwkv.d_model // rwkv.rwkv.head_dim,
                      "hd": rwkv.rwkv.head_dim},
        "mamba_scan": {"bt": SSM_BATCH, "t": SSM_PROMPT,
                       "di": jamba.mamba.expand * jamba.d_model,
                       "s": jamba.mamba.d_state},
    }


def wkv_fwd_programs_ms(r, k, v, w, u, s0, launch: dict,
                       repeats: int = 10) -> dict:
    """B8's chunked route with its two programs (``states``, ``chunks``)
    timed apart (ms) at ``launch``, through the library calls the wrapper
    makes."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk

    b, t, h, hd = r.shape
    chunk = launch["chunk"]
    states = torch.empty((b, h, -(-t // chunk), hd, hd), device=r.device)
    y, s_out = torch.empty_like(r), torch.empty_like(s0)
    lib = wkk._library()
    stream = torch.cuda.current_stream().cuda_stream

    def run_states():
        return lib.rwkv6_wkv_fwd_states(
            k.data_ptr(), v.data_ptr(), w.data_ptr(), s0.data_ptr(),
            states.data_ptr(), s_out.data_ptr(), b, t, h, hd, chunk,
            launch["cols"], stream)

    def run_chunks():
        return lib.rwkv6_wkv_fwd_chunks(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), states.data_ptr(), y.data_ptr(), b, t, h, hd, chunk,
            launch["block_h"], launch["split"], stream)

    check(run_states() == 0 and run_chunks() == 0,
          f"wkv6 programs refused at {launch}")
    return {"states_ms": device_ms(run_states, repeats),
            "chunks_ms": device_ms(run_chunks, repeats)}


def scan_bwd_programs_ms(x, dl, a, bm, cm, d, h0, dy, dh, launch: dict,
                         repeats: int = 10) -> dict:
    """B7's three programs (``summaries``, ``carry``, ``chunks``) timed apart
    (ms) at ``launch``, through the library calls the wrapper makes."""
    from repro_torch.kernels.mamba_scan import kernel as msk

    bt, t, di = x.shape
    s = a.shape[1]
    bd, chunk, split, span = (launch[key] for key in ("block_d", "chunk",
                                                      "split", "span"))
    n = -(-t // chunk)
    ns = -(-n // span)
    pc, hc = (torch.empty((bt, n, di, s), device=x.device) for _ in range(2))
    ps, hs, gs, da = (torch.empty((bt, ns, di, s), device=x.device)
                      for _ in range(4))
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db = torch.empty((-(-di // bd), bt, t, s), device=x.device)
    dc = torch.empty_like(db)
    dd = torch.empty((bt, ns, di), device=x.device)
    dh0 = torch.empty_like(h0)
    lib = msk._library_bwd()
    stream = torch.cuda.current_stream().cuda_stream

    def summaries():
        return lib.mamba_scan_bwd_summaries(
            x.data_ptr(), dl.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), dy.data_ptr(), pc.data_ptr(), hc.data_ptr(),
            ps.data_ptr(), hs.data_ptr(), gs.data_ptr(), bt, t, di, s, bd,
            chunk, split, span, stream)

    def carry():
        return lib.mamba_scan_bwd_carry(
            h0.data_ptr(), dh.data_ptr(), ps.data_ptr(), hs.data_ptr(),
            gs.data_ptr(), dh0.data_ptr(), bt, di, s, ns, stream)

    def chunks():
        return lib.mamba_scan_bwd_chunks(
            x.data_ptr(), dl.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), d.data_ptr(), dy.data_ptr(), pc.data_ptr(),
            hc.data_ptr(), hs.data_ptr(), gs.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
            dd.data_ptr(), bt, t, di, s, bd, chunk, split, span, stream)

    check(all(fn() == 0 for fn in (summaries, carry, chunks)),
          f"selective_scan_bwd programs refused at {launch}")
    # carry rewrites the span summaries in place at every call: neither its
    # time nor the chunk program's depends on the values
    return {"summaries_ms": device_ms(summaries, repeats),
            "carry_ms": device_ms(carry, repeats),
            "chunks_ms": device_ms(chunks, repeats)}


def phase_scan_parity(seed: int) -> list[dict]:
    """B8 and B6 at their prefill shapes, each in its default launch and
    one other, from a non-zero state, against their plain versions in
    float32 (atol 2e-4 / rtol 2e-3).  B8's chunked route (states and chunk
    programs timed apart) is held against the serial plain version, also at
    T 1000, with a quarter of its decays below 2.1e-9 and some 0, at hd 48,
    and twice for the same bits; its serial route at T = 1 (a decode step,
    also at hd 48).  B6 also at the Jamba training shape (B 2, timed, its
    own defaults and bound), at T 1000 and T = 1, with a quarter of its
    channels' a_t = 0, every case twice for the same bits."""
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan.ops import DEFAULTS as MS
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv.ops import DEFAULTS as WKV

    gen = torch.Generator("cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    metas = ssm_metas()
    cases, records = [], []

    # -- B8: r, k, v ~ N(0, 0.25), w = sigmoid(N + 2), u ~ N(0, 0.01), s0 ~ N
    b, t, h, hd = (metas["rwkv6_wkv"][k] for k in ("b", "t", "h", "hd"))
    r, k, v = (randn(b, t, h, hd) * 0.5 for _ in range(3))
    w = torch.sigmoid(randn(b, t, h, hd) + 2)
    u = randn(h, hd) * 0.1
    s0 = randn(b, h, hd, hd)
    other = {"chunk": 64, "split": 2, "cols": 8, "block_h": 2}
    oks, errs = [], []

    def wkv_case(label, args, launch, want, timed=False):
        got = wkk.wkv6_fwd(*args, **launch)
        ok, err = scan_gate(got, want)
        same = all(torch.equal(a_, g) for a_, g in
                   zip(wkk.wkv6_fwd(*args, **launch), got))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        tt, hd_ = args[0].shape[1], args[0].shape[3]
        case = {"kernel": "wkv6", "case": label, "t": tt, "hd": hd_,
                "route": wkk.route_of(tt, hd_, launch["chunk"]),
                "launch": dict(launch), "ok": ok and same and finite,
                "deterministic": same, "finite": finite, "max_abs_err": err}
        if timed:
            case["ms"] = device_ms(lambda: wkk.wkv6_fwd(*args, **launch), 50)
        cases.append(case)
        oks.append(case["ok"])
        errs.append(err)

    got, want, ms, plain_ms = timed_pair(
        lambda: wkk.wkv6_fwd(r, k, v, w, u, s0, **WKV),
        lambda: wkk.wkv6_fwd_plain(r, k, v, w, u, s0), 5)
    ok, err = scan_gate(got, want)
    same = all(torch.equal(a_, g) for a_, g in
               zip(wkk.wkv6_fwd(r, k, v, w, u, s0, **WKV), got))
    cases.append({"kernel": "wkv6", "case": "prefill", "t": t, "hd": hd,
                  "route": wkk.route_of(t, hd, WKV["chunk"]),
                  "launch": dict(WKV), "ok": ok and same,
                  "deterministic": same, "max_abs_err": err, "ms": ms,
                  **wkv_fwd_programs_ms(r, k, v, w, u, s0, WKV)})
    oks.append(ok and same)
    errs.append(err)
    del got
    wkv_case("prefill, another launch", (r, k, v, w, u, s0), other, want)
    cases[-1].update(ms=device_ms(lambda: wkk.wkv6_fwd(r, k, v, w, u, s0,
                                                       **other), 5),
                     **wkv_fwd_programs_ms(r, k, v, w, u, s0, other))
    del want
    w_tiny = w.clone()
    w_tiny[..., ::4] = torch.exp(-torch.exp(randn(b, t, h, hd // 4).abs() + 3))
    w_tiny[..., 1::9] = 0.0
    tiny_share = float((w_tiny < 2.1e-9).float().mean())
    wkv_case("tiny and zero decays", (r, k, v, w_tiny, u, s0), WKV,
             wkk.wkv6_fwd_plain(r, k, v, w_tiny, u, s0))
    cases[-1].update(share_below_2_1e_9=tiny_share,
                     share_zero=float((w_tiny == 0).float().mean()))
    del w_tiny
    t1_ms = None
    for tt, launch in ((1, WKV), (1000, WKV), (1000, other)):
        args = (r[:, :tt].contiguous(), k[:, :tt].contiguous(),
                v[:, :tt].contiguous(), w[:, :tt].contiguous(), u, s0)
        wkv_case(f"T {tt}", args, launch, wkk.wkv6_fwd_plain(*args),
                 timed=tt == 1)
        if tt == 1:
            t1_ms = cases[-1]["ms"]
    del r, k, v, w, u, s0, args
    args48 = [randn(2, 300, 4, 48) * 0.5 for _ in range(3)] + [
        torch.sigmoid(randn(2, 300, 4, 48) + 2), randn(4, 48) * 0.1,
        randn(2, 4, 48, 48)]
    for tt in (300, 1):
        args = [a_[:, :tt].contiguous() if a_.dim() == 4 and a_.shape[1] == 300
                else a_ for a_ in args48]
        wkv_case(f"hd 48, T {tt}", args, WKV, wkk.wkv6_fwd_plain(*args))
    del args48, args
    # bytes: r, k, v, w read and y written, u, s0 read and s_T written; the
    # chunked route's FMAs a token and head: one a state cell in the states
    # program, two in the chunks program (r . S and the state's step)
    n_bytes = 4 * (5 * b * t * h * hd + h * hd + 2 * b * h * hd * hd)
    n_ops = 3 * b * t * h * hd * hd
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops, INSTR_PER_S)
    records.append({
        "name": "wkv6_fwd", "ok": all(oks), "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:160",
        "launches": 0, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "t1_ms": t1_ms,
        # a decode step reads s0 and writes s_T (and a token's r, k, v, w, y)
        "t1_bound_ms": roofline_ms(
            4 * (5 * b * h * hd + h * hd + 2 * b * h * hd * hd), 0,
            INSTR_PER_S)[0]})
    torch.cuda.empty_cache()

    # -- B6: x ~ N, delta = |N| * 0.1, A = -(|N| + 0.5), B, C, D, h0 ~ N, at
    # the prefill shape and the training shape (the first JAMBA_TRAIN_BATCH
    # rows, its own defaults); then a quarter of the channels at delta =
    # 1 + |N| * 0.1 and A = -(|N| + 110), so that a_t = exp(delta A) is 0
    bt, t, di, s = (metas["mamba_scan"][k] for k in ("bt", "t", "di", "s"))
    x = randn(bt, t, di)
    dl = randn(bt, t, di).abs() * 0.1
    a = -(randn(di, s).abs() + 0.5)
    bm, cm = randn(bt, t, s), randn(bt, t, s)
    d, h0 = randn(di), randn(bt, di, s)
    oks, errs, timed = [], [], {}

    def scan_case(label, args, launch, want=None, timed_as=None):
        if timed_as:
            got, want, ms, plain_ms = timed_pair(
                lambda: msk.selective_scan_fwd(*args, **launch),
                lambda: msk.selective_scan_fwd_plain(*args), 5)
            timed[timed_as] = (ms, plain_ms)
        else:
            got = msk.selective_scan_fwd(*args, **launch)
            if want is None:
                want = msk.selective_scan_fwd_plain(*args)
        ok, err = scan_gate(got, want)
        same = all(torch.equal(a_, g) for a_, g in
                   zip(msk.selective_scan_fwd(*args, **launch), got))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        case = {"kernel": "selective_scan", "case": label,
                "bt": args[0].shape[0], "t": args[0].shape[1],
                "launch": dict(launch), "ok": ok and same and finite,
                "deterministic": same, "finite": finite, "max_abs_err": err}
        if timed_as:
            case["ms"] = timed[timed_as][0]
        cases.append(case)
        oks.append(case["ok"])
        errs.append(err)
        return want

    train_meta = {**metas["mamba_scan"], "bt": JAMBA_TRAIN_BATCH}
    ms_train = ms_ops.defaults(train_meta)
    other = {"block_d": 128, "chunk": 32, "split": 2}
    full = (x, dl, a, bm, cm, d, h0)
    want = scan_case("prefill", full, MS, timed_as="prefill")
    scan_case("prefill, another launch", full, other, want)
    cases[-1]["ms"] = device_ms(lambda: msk.selective_scan_fwd(*full,
                                                               **other), 5)
    del want
    train = tuple(m[:JAMBA_TRAIN_BATCH] if m.shape[0] == bt and m.dim() == 3
                  else m for m in full)
    scan_case("training shape", train, ms_train, timed_as="train")
    for tt in (1000, 1):
        args = tuple(m[:, :tt].contiguous() if m.dim() == 3 and m.shape[1] == t
                     else m for m in full)
        scan_case(f"T {tt}", args, MS)
    # dI 8190 (not a multiple of 4): the 4-byte staging copies and a
    # ragged last channel block, at the training batch and T 1000
    args = (x[:JAMBA_TRAIN_BATCH, :1000, :8190].contiguous(),
            dl[:JAMBA_TRAIN_BATCH, :1000, :8190].contiguous(), a[:8190],
            bm[:JAMBA_TRAIN_BATCH, :1000].contiguous(),
            cm[:JAMBA_TRAIN_BATCH, :1000].contiguous(), d[:8190],
            h0[:JAMBA_TRAIN_BATCH, :8190].contiguous())
    want = scan_case("dI 8190, 4-byte staging", args, MS)
    scan_case("dI 8190, 4-byte staging, training launch", args, ms_train,
              want)
    dl_u, a_u = dl.clone(), a.clone()
    dl_u[..., ::4] += 1.0
    a_u[::4] -= 110.0
    zero_share = float((torch.exp(dl_u[0, :64, :, None] * a_u) == 0)
                       .float().mean())
    scan_case("a_t = 0", (x, dl_u, a_u, bm, cm, d, h0), MS)
    cases[-1]["share_a_t_zero"] = zero_share
    del x, dl, a, bm, cm, d, h0, full, train, args, want, dl_u, a_u
    torch.cuda.empty_cache()

    def scan_bound(b_):
        # x, delta read and y written; B, C; A, D; h0 read and h_T written;
        # one exp a cell on the SFUs, or four FMA-pipe instructions
        cell = b_ * t * di * s
        n_bytes = 4 * (3 * b_ * t * di + 2 * b_ * t * s + di * s + di
                       + 2 * b_ * di * s)
        return max(roofline_ms(n_bytes, cell, SFU_OPS_PER_S),
                   roofline_ms(n_bytes, 4 * cell, INSTR_PER_S))

    bound_ms, bound_by = scan_bound(bt)
    train_bound_ms, train_bound_by = scan_bound(JAMBA_TRAIN_BATCH)
    records.append({
        "name": "selective_scan_fwd", "ok": all(oks), "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:166",
        "launches": 0, "max_abs_err": max(errs), "ms": timed["prefill"][0],
        "plain_ms": timed["prefill"][1], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "train_ms": timed["train"][0], "train_plain_ms": timed["train"][1],
        "train_bound_ms": train_bound_ms, "train_bound_by": train_bound_by})

    emit(phase="scan_parity", gate={"atol": 2e-4, "rtol": 2e-3},
         shapes=metas, cases=cases,
         ptxas={name: ptxas_report(name)
                for name in ("rwkv6_wkv", "mamba_scan")},
         results=[{key: rec.get(key) for key in (
             "name", "ok", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "t1_ms", "t1_bound_ms", "train_ms",
             "train_plain_ms", "train_bound_ms")} for rec in records])
    for case in cases:
        check(case["ok"], f"scan_parity: {case}")
    return records


def phase_ssm_tune(seed: int, store_path: Path, metas: dict | None = None,
                   phase: str = "ssm_tune") -> dict:
    """B8 at the RWKV-6 prefill shape and B6 at the Jamba prefill shape
    (or the kernels of ``metas`` at theirs), tuned into one store: each at
    most 5 % of its space, no refused launch, and a repeat from the cache
    with 0 measurements."""
    from repro_torch.tune import kernels as ktune

    outs, report = {}, []
    for name, meta in (metas or ssm_metas()).items():
        t0 = time.perf_counter()
        out = ktune.tune_kernel(name, meta, store=store_path, seed=seed)
        seconds = time.perf_counter() - t0
        default_s, best_s = out.default_time(), out.best_time()
        check(not out.result.from_cache, f"{name}: first tune from the cache")
        check(out.measured_fraction <= 0.05,
              f"{name}: measured {out.n_measured} of {out.space_size}")
        check(out.timer.n_launch_failed == 0,
              f"{name}: {out.timer.n_launch_failed} launches refused: "
              f"{out.timer.rejected}")
        again = ktune.tune_kernel(name, meta, store=store_path, seed=seed)
        check(again.result.from_cache and again.n_measured == 0,
              f"{name}: repeat was not a zero-measurement cache hit")
        check(again.best_config == out.best_config,
              f"{name}: cached config differs")
        outs[name] = out
        report.append({
            "kernel": name, "shape": meta, "seconds": round(seconds, 3),
            "space_size": out.space_size, "n_measured": out.n_measured,
            "measured_fraction": out.measured_fraction,
            "n_launch_failed": out.timer.n_launch_failed,
            "n_parity_rejected": sum("parity" in r for r in
                                     out.timer.rejected.values()),
            "default_config": out.default_config, "default_ms": default_s * 1e3,
            "best_config": out.best_config, "best_ms": best_s * 1e3,
            "best_source": out.best_source,
            "best_over_default": best_s / default_s,
            "repeat_from_cache": again.result.from_cache,
            "repeat_n_measured": again.n_measured})
        check(best_s <= default_s, f"{name}: the stored point "
                                   f"{out.best_config} is slower than the "
                                   "default it measured")
        # the timer keeps its full-size inputs and oracle output (3.2 GB
        # for the scan); the serving phases need only its count
        out.timer.inputs, out.timer._expected = (), None
        torch.cuda.empty_cache()
    emit(phase=phase, ok=True, tunes=report)
    return outs


def ssm_cfg(arch: str):
    return decoder_cfg(arch, JAMBA_LAYERS if arch == JAMBA_ARCH else None)


def seed_prompt(cfg, seed: int, batch: int, n: int) -> torch.Tensor:
    """The prompt ``serve_session`` draws from ``seed``, on the card."""
    import numpy as np

    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, n)), device="cuda")


def serve_split(model, prompt, gen: int, patch_embeds=None,
                ranges: tuple = ()) -> dict:
    """One prefill of ``prompt`` (after ``patch_embeds`` where given) and
    one decode step at the last position, each under ``torch.profiler``
    (``device_split``, with ``ranges``), after a warm run."""
    n = prompt.shape[1] + (0 if patch_embeds is None
                           else patch_embeds.shape[1])
    _, state = model.prefill(prompt, max_len=n + gen,
                             patch_embeds=patch_embeds)
    tok = prompt[:, -1:]
    pos = n + gen - 1

    def prefill():
        model.prefill(prompt, max_len=n + gen, patch_embeds=patch_embeds)

    def decode():
        model.decode_step(state, tok, pos)

    out = {}
    for label, fn in (("prefill", prefill), ("decode_step", decode)):
        fn()
        row = device_split(fn, ranges=ranges)
        out[label] = {k: row[k] for k in ("wall_ms", "device_busy_ms",
                                          "idle_share", "device_launches",
                                          "split_ms", *(("ranges_ms",)
                                                        if ranges else ()))}
        out[label]["top"] = row["top"][:6]
    del state
    return out


def phase_ssm_serve(arch: str, seed: int, store_path: Path, tunes: dict):
    """One recurrent serving path: its launch counters go to 0 just before
    ``serve_session`` and are read just after; every counter of the path
    must equal what its layers launch (prefill once per layer, decode per
    step where the layer's decode runs a kernel)."""
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import build_model
    from repro_torch.tune import kernels as ktune

    cfg = ssm_cfg(arch)
    check(cfg.compute_dtype == "bfloat16", f"{arch} computes in "
                                           f"{cfg.compute_dtype}")
    ktune.configure(store_path)
    measured = {name: tuned.timer.n_measured
                for name, tuned in tunes.items()}
    resolved = {name: ktune.resolve_config(name, meta, "float32",
                                           device="cuda")
                for name, meta in ssm_metas().items()}
    for name, tuned in tunes.items():
        check(resolved[name] == tuned.best_config,
              f"{arch}: {name} resolved {resolved[name]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed).cast_for_serving()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()

    kinds = cfg.layer_kinds
    want = {"wkv6_fwd": kinds.count("rwkv") * SSM_GEN,
            "selective_scan_fwd": kinds.count("mamba"),
            "flash_attention_fwd": kinds.count("attn"),
            "decode_attention": kinds.count("attn") * (SSM_GEN - 1)}
    want = {name: n for name, n in want.items() if n}
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk

    fns = {"wkv6_fwd": wkk.wkv6_fwd, "selective_scan_fwd":
           msk.selective_scan_fwd, "flash_attention_fwd":
           fak.flash_attention_fwd, "decode_attention": dak.decode_attention}
    for name in want:
        fns[name].launches = 0
    # B8's programs: the chunked route in prefill, the serial route at every
    # decode step
    n_rwkv = kinds.count("rwkv")
    programs = {"states": n_rwkv, "chunks": n_rwkv,
                "serial": n_rwkv * (SSM_GEN - 1)}
    wkk.wkv6_fwd.program_launches = {p_: 0 for p_ in programs}
    out = serve_session(cfg, batch=SSM_BATCH, prompt_len=SSM_PROMPT,
                        gen=SSM_GEN, seed=seed, model=model)
    launches = {name: fns[name].launches for name in want}
    if n_rwkv:
        launches.update({f"wkv6_fwd_{p_}": n for p_, n in
                         wkk.wkv6_fwd.program_launches.items()})
        want.update({f"wkv6_fwd_{p_}": n for p_, n in programs.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == want, f"{arch}: launches {launches}, want {want}")
    check(all(tuned.timer.n_measured == measured[name]
              for name, tuned in tunes.items()),
          f"{arch}: serving measured new configurations")
    generated = out["generated"]
    check(generated.shape == (SSM_BATCH, SSM_GEN)
          and ((0 <= generated) & (generated < cfg.vocab_size)).all(),
          f"{arch}: generated tokens {generated.shape}")
    split = serve_split(model, seed_prompt(cfg, seed, SSM_BATCH, SSM_PROMPT),
                        SSM_GEN)
    ktune.disable()
    phase = "rwkv_serve" if arch == RWKV_ARCH else "jamba_serve"
    emit(phase=phase, ok=True, arch=arch, n_layers=cfg.n_layers,
         layer_kinds=list(kinds), batch=SSM_BATCH, prompt_len=SSM_PROMPT,
         gen=SSM_GEN, params=cfg.param_count(), build_s=build_s,
         build_peak_gib=build_peak_gib, prefill_s=out["prefill_s"],
         decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
         resolved=resolved, launches=launches, peak_gib=peak_gib,
         profiled=split, first_tokens=generated[:, :8].tolist())
    return model, generated, launches


def plain_patches():
    """Every kernel of the recurrent paths swapped for its plain version
    where the ops call it."""
    from unittest import mock

    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def plain_decode(q, k, v, length, **launch):
        return dak.decode_attention_plain(q, k, v, length)

    def plain_wkv(r, k, v, w, u, s0, **launch):
        return wkk.wkv6_fwd_plain(r, k, v, w, u, s0)

    def plain_scan(x, dl, a, b, c, d, h0, **launch):
        return msk.selective_scan_fwd_plain(x, dl, a, b, c, d, h0)

    return [mock.patch.object(fa_ops, "flash_attention_fwd",
                              plain_attention_fwd),
            mock.patch.object(da_ops, "decode_attention_kernel", plain_decode),
            mock.patch.object(wkv_ops, "wkv6_fwd", plain_wkv),
            mock.patch.object(ms_ops, "selective_scan_fwd", plain_scan)]


def teacher_forced(model, prompt, feed, patches=(), routes=None,
                   patch_embeds=None) -> tuple[list, list, int]:
    """Prefill ``prompt`` (after a VLM's ``patch_embeds`` where given), then
    decode ``feed`` (the generated tokens, all but the last) token by
    token; returns each
    step's logits, the expert choices of every MoE call of each step, and
    how many (token, choice) pairs the router would have chosen otherwise.

    ``routes`` (another run's choices) pins every MoE call to them, as the
    tokens are pinned: a router choosing among experts that tie to the
    last bits flips on a rounding difference and moves that token's output
    by O(1), which says nothing of the kernels.  ``patches`` are entered
    around the run (kernels swapped for plain versions)."""
    import contextlib
    from unittest import mock

    from repro_torch.models import moe

    real_top_k = moe.top_k
    seen: list[list[torch.Tensor]] = []
    moved = [0]

    def top_k(probs, k):
        vals, idx = real_top_k(probs, k)
        if routes is not None:
            pinned = routes[len(seen) - 1][len(seen[-1])]
            moved[0] += int((pinned != idx).sum())
            idx = pinned
            vals = torch.gather(probs, -1, idx)
        seen[-1].append(idx)
        return vals, idx

    n = prompt.shape[1] + (0 if patch_embeds is None
                           else patch_embeds.shape[1])
    with contextlib.ExitStack() as stack:
        for patch in (mock.patch.object(moe, "top_k", top_k), *patches):
            stack.enter_context(patch)
        seen.append([])
        logits, state = model.prefill(prompt, max_len=n + feed.shape[1],
                                      patch_embeds=patch_embeds)
        steps = [logits]
        for i in range(feed.shape[1] - 1):
            seen.append([])
            logits, state = model.decode_step(state, feed[:, i:i + 1], n + i)
            steps.append(logits)
    del state
    return steps, seen, moved[0]


def logit_gap(got: list, want: list) -> list[float]:
    """Each step's largest logit difference over its largest logit."""
    return [float((a - p).abs().max() / p.abs().max())
            for a, p in zip(got, want)]


def chunked_plain_patches():
    """The scans' plain versions in other forms (B8's chunked route at
    chunk 32; B6 with y_t's sum taken entry by entry, folded by halves as
    its kernel folds its parts) whatever the launch parameters: another
    float32 summation order of the same function, which gives the bf16
    model's own noise floor."""
    from unittest import mock

    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def wkv(r, k, v, w, u, s0, **launch):
        return wkk.wkv6_fwd_chunked_plain(r, k, v, w, u, s0, chunk=32)

    def scan(x, dl, a, b, c, d, h0, **launch):
        return msk.selective_scan_fwd_plain(x, dl, a, b, c, d, h0,
                                            split=a.shape[1])

    return [p for p in plain_patches()
            if p.attribute not in ("wkv6_fwd", "selective_scan_fwd")] + [
        mock.patch.object(wkv_ops, "wkv6_fwd", wkv),
        mock.patch.object(ms_ops, "selective_scan_fwd", scan)]


# the float32 parity gate: the largest logit difference of any step at most
# this share of the step's largest logit
F32_PARITY_GATE = 1e-3
# the bf16 gate: lm_parity's 5 %, or this multiple of the bf16 noise floor
# (the plain versions against their own chunked form) where that is larger
BF16_FLOOR_MARGIN = 1.5


def phase_ssm_parity(model, generated, seed: int) -> None:
    """The same weights with the kernels and with the plain versions, on
    the card, teacher-forced on the first ``SSM_PARITY_STEPS`` generated
    tokens after the first ``SSM_PARITY_PROMPT`` tokens of the prompt (the
    chunked wkv route and the selective scan in the prefill, as served),
    first as served (bf16) and then in float32.

    Every run after the first is pinned to the first's expert choices
    (``teacher_forced``), and reports how many choices its own router
    would have made otherwise.  bf16 is reported beside its own noise
    floor, the plain versions against the plain versions' chunked form (the
    same function summed in another float32 order): a random-weight RWKV-6
    at 24 layers amplifies one bf16 ulp, flipped where two float32 sums
    round apart, to ~5-7 % of the largest logit (measured on the CPU at d
    1024 and on the card), so a 5 % gate alone would measure bf16: bf16 is
    held to the larger of 5 % and ``BF16_FLOOR_MARGIN`` times that floor.
    The tight gate is float32: the same architecture rebuilt in float32
    from ``seed`` (compute in float32, TF32 off), kernels vs plain
    versions, at most ``F32_PARITY_GATE`` of each step's largest logit
    (float32 orders differ by ~1e-5 at 24 layers; a wrong state, mask or
    cache slot moves logits by their own size).  Frees ``model``'s weights before the float32
    build: the caller must hold no other reference."""
    import dataclasses

    import numpy as np

    from repro_torch.models import build_model

    cfg = model.cfg
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT)), device="cuda")[
            :, :SSM_PARITY_PROMPT]
    feed = torch.as_tensor(generated, device="cuda")[:, :SSM_PARITY_STEPS]
    phase = "rwkv_parity" if "rwkv" in cfg.layer_kinds else "jamba_parity"

    kern, routes, _ = teacher_forced(model, prompt, feed)
    plain, _, moved = teacher_forced(model, prompt, feed, plain_patches(),
                                     routes)
    floor, _, floor_moved = teacher_forced(model, prompt, feed,
                                           chunked_plain_patches(), routes)
    gap, floor_gap = logit_gap(kern, plain), logit_gap(floor, plain)
    bf16 = {"rel_err_max": max(gap), "rel_err_mean": float(np.mean(gap)),
            "floor_rel_err_max": max(floor_gap),
            "floor_rel_err_mean": float(np.mean(floor_gap)),
            "gate": max(0.05, BF16_FLOOR_MARGIN * max(floor_gap)),
            "choices_pinned": moved, "floor_choices_pinned": floor_moved,
            "argmax_agreement": float(np.mean([
                float((a.argmax(-1) == p.argmax(-1)).float().mean())
                for a, p in zip(kern, plain)])),
            "logit_abs_max": float(kern[0].abs().max())}
    finite = bool(torch.isfinite(torch.stack(kern)).all())
    shape = tuple(kern[0].shape)
    del kern, plain, floor
    for p in model.parameters():
        p.data = torch.empty(0, device="cuda")
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, seed=seed)
    kern, routes, _ = teacher_forced(model32, prompt, feed)
    plain, _, moved = teacher_forced(model32, prompt, feed, plain_patches(),
                                     routes)
    rel = logit_gap(kern, plain)
    f32 = {"rel_err_by_step": rel, "prefill_rel_err": rel[0],
           "decode_rel_err_max": max(rel[1:]),
           "decode_rel_err_mean": float(np.mean(rel[1:])),
           "choices_pinned": moved,
           "logit_abs_max": float(kern[0].abs().max()),
           "gate": F32_PARITY_GATE}
    finite = finite and bool(torch.isfinite(torch.stack(kern)).all())
    del kern, plain, model32
    torch.cuda.empty_cache()
    emit(phase=phase, arch=cfg.name, steps=len(rel),
         prompt_len=prompt.shape[1], bf16=bf16, float32=f32)
    check(finite, f"{phase}: non-finite logits")
    check(shape == (SSM_BATCH, 1, cfg.vocab_size),
          f"{phase}: prefill logits {shape}")
    check(max(rel) <= F32_PARITY_GATE,
          f"{phase}: float32 relative logit error {max(rel)}")
    check(bf16["rel_err_max"] <= bf16["gate"],
          f"{phase}: bf16 relative logit error {bf16['rel_err_max']} over "
          f"{bf16['gate']}")


# -- the recurrent training paths (RWKV-6, Jamba's first period) -----------------

# kernels against plain versions in float32 compute: the loss's relative
# error; each parameter's gradient against the float64 gradient by relative
# L2, within this gate, or, where that is larger, within this multiple of
# the plain versions' largest distance from the float64 gradient over the
# leaves of the same parameter (the same name in every layer)
SSM_LOSS_GATE, SSM_GRAD_GATE, GRAD_FLOOR_MARGIN = 1e-4, 1e-3, 1.5


def ssm_train_metas() -> dict:
    """The shapes the training paths give the backward kernels (the specs'
    default shapes) and the selective scan's forward (Jamba's training
    batch; RWKV-6 trains B8 at its serving shape)."""
    from repro_torch import configs

    rwkv, jamba = configs.get(RWKV_ARCH), configs.get(JAMBA_ARCH)
    return {
        "mamba_scan": {"bt": JAMBA_TRAIN_BATCH, "t": TRAIN_SEQ,
                       "di": jamba.mamba.expand * jamba.d_model,
                       "s": jamba.mamba.d_state},
        "rwkv6_wkv_bwd": {"b": RWKV_TRAIN_BATCH, "t": TRAIN_SEQ,
                          "h": rwkv.d_model // rwkv.rwkv.head_dim,
                          "hd": rwkv.rwkv.head_dim},
        "mamba_scan_bwd": {"bt": JAMBA_TRAIN_BATCH, "t": TRAIN_SEQ,
                           "di": jamba.mamba.expand * jamba.d_model,
                           "s": jamba.mamba.d_state},
    }


def phase_scan_bwd_parity(seed: int) -> list[dict]:
    """B9 and B7 at their training shapes, at a ragged T (1000) and at
    T = 1, from non-zero states with non-zero cotangents, against their
    plain versions in float32 (atol 2e-4 / rtol 2e-3, the reference's
    ``*_bwd`` specs); each run twice for the same bits.  B9 also with a
    quarter of its decays below 2.1e-9 and at hd 48; B7 also with a
    quarter of its channels' decays underflowing to 0, and its three
    programs timed apart."""
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan.ops import BWD_DEFAULTS as MSB
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv.ops import BWD_DEFAULTS as WKVB

    gen = torch.Generator("cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    metas = ssm_train_metas()
    cases, records = [], []

    def run(name, kernel_fn, plain_fn, t, launch, timed):
        if timed:
            got, want, ms, plain_ms = timed_pair(kernel_fn, plain_fn, 5)
        else:
            got, want, ms, plain_ms = kernel_fn(), plain_fn(), None, None
        ok, err = scan_gate(got, want)
        same = all(torch.equal(a, g) for a, g in zip(kernel_fn(), got))
        cases.append({"kernel": name, "t": t, "launch": dict(launch),
                      "ok": ok and same, "deterministic": same,
                      "max_abs_err": err, **({"ms": ms} if timed else {})})
        return ok and same, err, ms, plain_ms

    # -- B9: r, k, v ~ N(0, 0.25), w = sigmoid(N + 2), u ~ N(0, 0.01); s0,
    # dy, ds_T ~ N(0, 1); then the same with a quarter of the channels
    # decays w = exp(-exp(|N| + 3)) (all below 2.1e-9: every product of
    # two underflows), and hd 48 (C5 lifted)
    b, t, h, hd = (metas["rwkv6_wkv_bwd"][k] for k in ("b", "t", "h", "hd"))
    r, k, v = (randn(b, t, h, hd) * 0.5 for _ in range(3))
    w = torch.sigmoid(randn(b, t, h, hd) + 2)
    u = randn(h, hd) * 0.1
    s0, dy, ds = randn(b, h, hd, hd), randn(b, t, h, hd), randn(b, h, hd, hd)
    oks, errs = [], []
    for tt in (t, 1000, 1):
        args = [m[:, :tt].contiguous() if m.dim() == 4 and m.shape[1] == t
                else m for m in (r, k, v, w, u, s0, dy, ds)]
        ok, err, ms_t, plain_t = run(
            "wkv6_bwd", lambda: wkk.wkv6_bwd(*args, **WKVB),
            lambda: wkk.wkv6_bwd_plain(*args), tt, WKVB, tt == t)
        oks.append(ok)
        errs.append(err)
        if tt == t:
            ms, plain_ms = ms_t, plain_t
    w_tiny = w.clone()
    w_tiny[..., ::4] = torch.exp(-torch.exp(randn(b, t, h, hd // 4).abs() + 3))
    tiny_share = float((w_tiny < 1e-6).float().mean())
    args = (r, k, v, w_tiny, u, s0, dy, ds)
    ok, err, _, _ = run("wkv6_bwd tiny decays",
                        lambda: wkk.wkv6_bwd(*args, **WKVB),
                        lambda: wkk.wkv6_bwd_plain(*args), t, WKVB, False)
    finite = all(bool(torch.isfinite(g).all())
                 for g in wkk.wkv6_bwd(*args, **WKVB))
    cases[-1].update({"share_below_1e-6": tiny_share, "finite": finite})
    cases[-1]["ok"] = cases[-1]["ok"] and finite
    oks.append(ok and finite)
    errs.append(err)
    del w_tiny, args
    args48 = [randn(2, 300, 4, 48) * 0.5 for _ in range(3)] + [
        torch.sigmoid(randn(2, 300, 4, 48) + 2), randn(4, 48) * 0.1,
        randn(2, 4, 48, 48), randn(2, 300, 4, 48), randn(2, 4, 48, 48)]
    launch48 = {**WKVB, "cols": 16}
    ok, err, _, _ = run("wkv6_bwd hd 48",
                        lambda: wkk.wkv6_bwd(*args48, **launch48),
                        lambda: wkk.wkv6_bwd_plain(*args48), 300, launch48,
                        False)
    oks.append(ok)
    del r, k, v, w, u, s0, dy, ds, args48
    cell = b * t * h * hd * hd
    # r, k, v, w, dy read and dr, dk, dv, dw written; u, du; s0, ds_T, ds0
    n_bytes = 4 * (9 * b * t * h * hd + 2 * h * hd + 3 * b * h * hd * hd)
    # the chunked form's FMAs a token and head: S0 dy, G v and G^T (B k)
    # (3 hd^2), one a cell in each scan (2 hd^2), the in-chunk pairs
    # (~6 chunk hd); the serial form's eight a state cell stand beside it
    n_ops = b * t * h * (5 * hd * hd + 6 * WKVB["chunk"] * hd)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops, INSTR_PER_S)
    records.append({
        "name": "wkv6_bwd", "ok": all(oks), "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:255",
        "launches": 0, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "bound_8_per_cell_ms": roofline_ms(n_bytes, 8 * cell,
                                           INSTR_PER_S)[0]})
    torch.cuda.empty_cache()

    # -- B7: x ~ N, delta = |N| * 0.1, A = -(|N| + 0.5), B, C, D, h0, dy,
    # dh_T ~ N; then the same with a quarter of the channels at delta =
    # 1 + |N| * 0.1 and A = -(|N| + 110), so that delta * A < -104 and
    # a_t = exp(delta A) is 0 in float32
    bt, t, di, s = (metas["mamba_scan_bwd"][k] for k in ("bt", "t", "di", "s"))
    x = randn(bt, t, di)
    dl = randn(bt, t, di).abs() * 0.1
    a = -(randn(di, s).abs() + 0.5)
    bm, cm = randn(bt, t, s), randn(bt, t, s)
    d, h0, dy, dh = randn(di), randn(bt, di, s), randn(bt, t, di), randn(bt, di, s)
    oks, errs = [], []
    for tt in (t, 1000, 1):
        args = [m[:, :tt].contiguous() if m.dim() == 3 and m.shape[1] == t
                and m is not h0 and m is not dh else m
                for m in (x, dl, a, bm, cm, d, h0, dy, dh)]
        ok, err, ms_t, plain_t = run(
            "selective_scan_bwd",
            lambda: msk.selective_scan_bwd(*args, **MSB),
            lambda: msk.selective_scan_bwd_plain(*args, chunk=MSB["chunk"]),
            tt, MSB, tt == t)
        oks.append(ok)
        errs.append(err)
        if tt == t:
            ms, plain_ms = ms_t, plain_t
            cases[-1].update(scan_bwd_programs_ms(*args, MSB))
    dl_u, a_u = dl.clone(), a.clone()
    dl_u[..., ::4] += 1.0
    a_u[::4] -= 110.0
    zero_share = float((torch.exp(dl_u[0, :64, :, None] * a_u) == 0)
                       .float().mean())
    args = (x, dl_u, a_u, bm, cm, d, h0, dy, dh)
    ok, err, _, _ = run("selective_scan_bwd a_t = 0",
                        lambda: msk.selective_scan_bwd(*args, **MSB),
                        lambda: msk.selective_scan_bwd_plain(
                            *args, chunk=MSB["chunk"]), t, MSB, False)
    finite = all(bool(torch.isfinite(g).all())
                 for g in msk.selective_scan_bwd(*args, **MSB))
    cases[-1].update({"share_a_t_zero": zero_share, "finite": finite})
    cases[-1]["ok"] = cases[-1]["ok"] and finite
    oks.append(ok and finite)
    errs.append(err)
    del x, dl, a, bm, cm, d, h0, dy, dh, args, dl_u, a_u
    torch.cuda.empty_cache()
    cell = bt * t * di * s
    # x, delta, dy read and dx, ddelta written; B, C and dB, dC; A, dA; D,
    # dD; h0, dh_T, dh0
    n_bytes = 4 * (5 * bt * t * di + 4 * bt * t * s + 2 * di * s + 2 * di
                   + 3 * bt * di * s)
    by_sfu = roofline_ms(n_bytes, cell, SFU_OPS_PER_S)
    by_fma = roofline_ms(n_bytes, 8 * cell, INSTR_PER_S)
    bound_ms, bound_by = max(by_sfu, by_fma)
    records.append({
        "name": "selective_scan_bwd", "ok": all(oks), "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:263",
        "launches": 0, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None})

    emit(phase="scan_bwd_parity", gate={"atol": 2e-4, "rtol": 2e-3},
         shapes=metas, cases=cases,
         ptxas={name: ptxas_report(name)
                for name in ("mamba_scan_bwd", "rwkv6_wkv_bwd")},
         results=[{key: rec.get(key) for key in (
             "name", "ok", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "bound_8_per_cell_ms")} for rec in records])
    for case in cases:
        check(case["ok"], f"scan_bwd_parity: {case}")
    return records


def ssm_train_cfg(arch: str, compute_dtype: str):
    """The training configuration: RWKV-6 1.6B whole; Jamba cut to its
    first period (``ssm_cfg``) without experts, every channel the dense
    SwiGLU (its 13.3e9 parameters with experts are 213 GB of training
    state)."""
    import dataclasses

    cfg = ssm_cfg(arch)
    if arch == JAMBA_ARCH:
        cfg = dataclasses.replace(cfg, moe=None)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def train_plain_patches():
    """Every kernel of the recurrent training paths, forward and backward,
    swapped for its plain version where the ops call it."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def plain_wkv_bwd(*args, **launch):
        return wkk.wkv6_bwd_plain(*args)

    def plain_scan_bwd(*args, chunk, **launch):
        return msk.selective_scan_bwd_plain(*args, chunk=chunk)

    return plain_patches() + [
        mock.patch.object(fa_ops, "flash_attention_bwd", plain_attention_bwd),
        mock.patch.object(wkv_ops, "wkv6_bwd", plain_wkv_bwd),
        mock.patch.object(ms_ops, "selective_scan_bwd", plain_scan_bwd)]


class Plain64(torch.autograd.Function):
    """``fwd`` of the operands in float64, its gradient by ``bwd`` (a plain
    backward version) in float64."""

    @staticmethod
    def forward(ctx, fwd, bwd, *args):
        args = [a.double().contiguous() for a in args]
        ctx.save_for_backward(*args)
        ctx.bwd = bwd
        return fwd(*args)

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.bwd(*ctx.saved_tensors,
                        *(c.double().contiguous() for c in cts))
        return (None, None, *grads)


def float64_patches():
    """The recurrences and attention in float64: the scans' plain
    versions forward and backward, attention by autograd of its
    materialised softmax."""
    from functools import partial
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def wkv64(r, k, v, w, u, s0=None, **launch):
        b, _, h, hd = r.shape
        if s0 is None:
            s0 = torch.zeros((b, h, hd, hd), dtype=torch.float64,
                             device=r.device)
        return Plain64.apply(wkk.wkv6_fwd_plain, wkk.wkv6_bwd_plain, r, k,
                             v, w, u, s0)

    def scan64(x, delta, a, b, c, d, h0=None, **launch):
        if h0 is None:
            h0 = torch.zeros((x.shape[0], x.shape[2], a.shape[1]),
                             dtype=torch.float64, device=x.device)
        return Plain64.apply(msk.selective_scan_fwd_plain,
                             partial(msk.selective_scan_bwd_plain, chunk=16),
                             x, delta, a, b, c, d, h0)

    def attn64(q, k, v, *, causal=True, q_offset=0, **launch):
        tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) \
            * hd ** -0.5
        if causal:
            qpos = q_offset + torch.arange(tq, device=q.device)
            kpos = torch.arange(tk, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                            v.double())

    return [mock.patch.object(wkv_ops, "wkv6", wkv64),
            mock.patch.object(ms_ops, "selective_scan", scan64),
            mock.patch.object(fa_ops, "flash_attention", attn64)]


def float64_grads(model, batch):
    """The loss and the gradient with the parameters, the products, the
    recurrences and attention in float64 (the model's own float32 casts
    around the scans aside), cast to float32; the model is restored."""
    import dataclasses

    cfg = model.cfg
    for p in model.parameters():
        p.data = p.data.double()
    model.cfg = dataclasses.replace(cfg, compute_dtype="float64")
    try:
        loss, grads = ssm_grads(model, batch, float64_patches())
        grads = {n: g.float() for n, g in grads.items()}
    finally:
        for p in model.parameters():
            p.data = p.data.float()
        model.cfg = cfg
    return loss.float(), grads


def wrong_backward_controls() -> dict:
    """One wrong backward per new kernel: B7 with dB and dC swapped, B9
    with du dropped; each still runs the kernel."""
    from unittest import mock

    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def scan_db_dc_swapped(*args, **launch):
        dx, ddt, da, db, dc, dd, dh0 = msk.selective_scan_bwd(*args, **launch)
        return dx, ddt, da, dc, db, dd, dh0

    def wkv_without_du(*args, **launch):
        dr, dk, dv, dw, du, ds0 = wkk.wkv6_bwd(*args, **launch)
        return dr, dk, dv, dw, torch.zeros_like(du), ds0

    return {"B7 dB/dC swapped": mock.patch.object(
                ms_ops, "selective_scan_bwd", scan_db_dc_swapped),
            "B9 without du": mock.patch.object(
                wkv_ops, "wkv6_bwd", wkv_without_du)}


def ssm_grads(model, batch, patches=()):
    """One loss-and-gradient pass (each layer recomputed), with
    ``patches`` entered around it."""
    import contextlib

    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, remat=True)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def rel_l2_leaves(grads, want) -> dict:
    """Each parameter's gradient against ``want``'s by relative L2."""
    return {n: float((grads[n].float() - want[n].float()).norm()
                     / want[n].float().norm().clamp_min(1e-30))
            for n in grads}


def summary(rel: dict) -> dict:
    """The largest of per-leaf readings, the three worst, the mean."""
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    return {"max": worst[0][1], "worst": worst[:3],
            "mean": sum(rel.values()) / len(rel)}


def rel_l2(grads, want) -> dict:
    return summary(rel_l2_leaves(grads, want))


def leaf_kind(name: str) -> str:
    """A parameter's name with its layer index left out: the leaves of one
    parameter in every layer."""
    return re.sub(r"^(layers|encoder|decoder)\.\d+\.", r"\1.*.", name)


def leaf_gates(plain: dict, floor: float = SSM_GRAD_GATE) -> dict:
    """Each parameter's gradient gate (``floor``, or
    ``GRAD_FLOOR_MARGIN`` times the plain float32 path's largest distance
    from float64 over the same parameter's leaves where that is larger),
    keyed by ``leaf_kind``.  One leaf's own reading is a single draw of
    float32 rounding noise; the same parameter's leaves in every layer
    are draws of one size."""
    worst: dict[str, float] = {}
    for n, e in plain.items():
        worst[leaf_kind(n)] = max(worst.get(leaf_kind(n), 0.0), e)
    return {k: max(floor, GRAD_FLOOR_MARGIN * e) for k, e in worst.items()}


def over_gate(rel: dict, gates: dict) -> dict:
    """The leaves whose reading exceeds their parameter's gate, each with
    its reading and gate."""
    return {n: [e, gates[leaf_kind(n)]] for n, e in rel.items()
            if e > gates[leaf_kind(n)]}


def phase_ssm_train_parity(arch: str, seed: int):
    """One loss-and-gradient pass at full width with the kernels and one
    with the plain versions patched in, in float32 compute (TF32 off), each
    held against the float64 gradient (``float64_grads``): the loss within
    ``SSM_LOSS_GATE`` of the plain versions', and each parameter's gradient
    within its gate (``leaf_gates``) of the float64 one by relative L2.  A
    random-weight RWKV-6 computes most of its gradients in float32 only to
    ~1e-2 whatever the kernels (the plain path too; only the decay's, the
    head's and the final norm's reach ~1e-4), so for such a parameter the
    kernels are held to be as close to the float64 gradient as the plain
    float32 path is over the same parameter's leaves; every other
    parameter keeps ``SSM_GRAD_GATE``.  bf16 turns one ulp into ~7 %
    of the largest logit and would swamp any gradient gate; a wrong adjoint
    moves a gradient by its own size.  Each wrong backward of
    ``wrong_backward_controls`` runs too, against the same gates, reported
    beside whether they catch it.  Then the same pass in bf16 compute (as
    the training paths train), through the kernels and through the plain
    versions: their gap, and each one's relative L2 from the float64
    gradient per parameter beside the float32 kernel path's (C4), are
    reported, not gated.  Returns the model, float32 parameters, set to bf16 compute for
    training, and the report, with every leaf's readings under
    ``leaves``."""
    import dataclasses

    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ssm_train_cfg(arch, "float32")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    seq = SSM_PARITY_SEQ[arch]
    batch = train_batch(cfg, seed, batch=SSM_PARITY_BATCH, seq=seq)

    loss_64, truth = float64_grads(model, batch)
    torch.cuda.empty_cache()
    loss_k, grads = ssm_grads(model, batch)
    finite = bool(torch.isfinite(loss_k)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    err_k = rel_l2_leaves(grads, truth)
    loss_p, grads_p = ssm_grads(model, batch, train_plain_patches())
    gaps = rel_l2(grads, grads_p)
    del grads
    err_p = rel_l2_leaves(grads_p, truth)
    del grads_p
    loss_rel = float((loss_k - loss_p).abs() / loss_p.abs())
    gates = leaf_gates(err_p)
    failed = over_gate(err_k, gates)
    # the parameters held to more than SSM_GRAD_GATE: each gate with the
    # kernels' and the plain path's largest distance over its leaves
    loosened = {kind: {"gate": g, "kernels_max": max(
        e for n, e in err_k.items() if leaf_kind(n) == kind),
        "plain_max": max(e for n, e in err_p.items() if leaf_kind(n) == kind)}
        for kind, g in sorted(gates.items()) if g > SSM_GRAD_GATE}
    controls = {}
    for name, patch in wrong_backward_controls().items():
        kinds = set(cfg.layer_kinds)
        if ("B7" in name) != ("mamba" in kinds):
            continue
        _, grads_c = ssm_grads(model, batch, [patch])
        err_c = rel_l2_leaves(grads_c, truth)
        del grads_c
        caught = over_gate(err_c, gates)
        controls[name] = {"grad_rel_l2_max": max(err_c.values()),
                          "leaves_over_gate": len(caught),
                          "worst_over_gate": sorted(
                              caught.items(), key=lambda kv: -kv[1][0])[:1],
                          "caught": bool(caught)}
    torch.cuda.empty_cache()

    # bf16 compute, the same weights, as rwkv_train and jamba_train train:
    # the kernels against the plain versions, and both against the float64
    # pass (C4), each parameter beside the float32 kernel path's reading;
    # reported, not gated
    model.cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bl_k, bg_k = ssm_grads(model, batch)
    err_bk = rel_l2_leaves(bg_k, truth)
    bl_p, bg_p = ssm_grads(model, batch, train_plain_patches())
    err_bp = rel_l2_leaves(bg_p, truth)
    del truth
    bf16 = rel_l2(bg_k, bg_p)
    del bg_k, bg_p
    torch.cuda.empty_cache()

    def by_param(rel: dict) -> dict:
        worst: dict[str, float] = {}
        for n, e in rel.items():
            worst[leaf_kind(n)] = max(worst.get(leaf_kind(n), 0.0), e)
        return worst

    bk, bp, fk = by_param(err_bk), by_param(err_bp), by_param(err_k)
    vs_float64 = {kind: {"bf16_kernels": bk[kind], "bf16_plain": bp[kind],
                         "float32_kernels": fk[kind]}
                  for kind in sorted(bk, key=lambda n: -bk[n])}
    phase = "rwkv_train_parity" if arch == RWKV_ARCH else "jamba_train_parity"
    report = dict(
        phase=phase, arch=arch, seed=seed, n_layers=cfg.n_layers,
        layer_kinds=list(cfg.layer_kinds), moe=cfg.moe is not None,
        params=sum(p.numel() for p in model.parameters()), build_s=build_s,
        batch=SSM_PARITY_BATCH, seq_len=seq, float32={
            "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "loss_float64": float(loss_64), "loss_rel_err": loss_rel,
            "loss_gate": SSM_LOSS_GATE,
            "kernels_vs_float64": summary(err_k),
            "plain_vs_float64": summary(err_p),
            "kernels_vs_plain": gaps, "grad_gate": SSM_GRAD_GATE,
            "grad_gates_above": loosened, "leaves_over_gate": failed},
        bf16={"loss_kernels": float(bl_k), "loss_plain": float(bl_p),
              "loss_rel_err": float((bl_k - bl_p).abs() / bl_p.abs()),
              "grad_rel_l2_max": bf16["max"],
              "grad_rel_l2_worst": bf16["worst"],
              "grad_rel_l2_mean": bf16["mean"],
              "kernels_vs_float64": summary(err_bk),
              "plain_vs_float64": summary(err_bp),
              "vs_float64_by_param": vs_float64},
        controls=controls)
    emit(**report)
    report["leaves"] = {"kernels_vs_float64": err_k, "plain_vs_float64": err_p}
    check(finite, f"{phase}: non-finite loss or gradient")
    check(loss_rel <= SSM_LOSS_GATE,
          f"{phase}: loss {float(loss_k)} vs {float(loss_p)}")
    check(not failed, f"{phase}: gradients over their gates: {failed}")
    check(controls and all(c["caught"] for c in controls.values()),
          f"{phase}: a wrong backward passed the gate: {controls}")
    return model, report


def phase_ssm_train(model, seed: int, store_path: Path, tunes: dict) -> dict:
    """One recurrent training path: ``train_loop`` takes TRAIN_STEPS steps
    with the tuned store configured; its launch counters go to 0 just
    before and are read just after, and must be exact (remat runs each
    forward twice, each backward once).  The store must serve the backward
    kernels' tuned parameters with no new measurement."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.tune import kernels as ktune

    cfg = model.cfg
    arch = RWKV_ARCH if "rwkv" in cfg.layer_kinds else JAMBA_ARCH
    batch = RWKV_TRAIN_BATCH if arch == RWKV_ARCH else JAMBA_TRAIN_BATCH
    check(cfg.compute_dtype == "bfloat16" and cfg.param_dtype == "float32",
          f"{arch}: trains {cfg.param_dtype} in {cfg.compute_dtype}")
    ktune.configure(store_path)
    measured = {name: tuned.timer.n_measured for name, tuned in tunes.items()}
    resolved = {name: ktune.resolve_config(name, meta, "float32",
                                           device="cuda")
                for name, meta in ssm_train_metas().items()}
    for name in resolved:
        check(resolved[name] == tunes[name].best_config,
              f"{arch}: {name} resolved {resolved[name]}")

    fns = {"wkv6_fwd": wkk.wkv6_fwd, "wkv6_bwd": wkk.wkv6_bwd,
           "selective_scan_fwd": msk.selective_scan_fwd,
           "selective_scan_bwd": msk.selective_scan_bwd,
           "flash_attention_fwd": fak.flash_attention_fwd,
           "flash_attention_bwd": fak.flash_attention_bwd}
    programs = {"wkv6_fwd": ("states", "chunks", "serial"),
                "wkv6_bwd": ("scans", "chunks"),
                "selective_scan_bwd": ("summaries", "carry", "chunks"),
                "flash_attention_bwd": ("dq", "dkv")}
    for name, fn in fns.items():
        fn.launches = 0
        if name in programs:
            fn.program_launches = {p: 0 for p in programs[name]}
    torch.cuda.reset_peak_memory_stats()
    out = train_loop(cfg, steps_total=TRAIN_STEPS, batch=batch,
                     seq_len=TRAIN_SEQ, seed=seed, remat=True, log_every=0,
                     model=model)
    launches = {}
    for name, fn in fns.items():
        launches[name] = fn.launches
        for prog in programs.get(name, ()):
            launches[f"{name}_{prog}"] = fn.program_launches[prog]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    kinds = cfg.layer_kinds
    n = {kind: kinds.count(kind) * TRAIN_STEPS
         for kind in ("rwkv", "mamba", "attn")}
    want = {"wkv6_fwd": 2 * n["rwkv"], "wkv6_bwd": n["rwkv"],
            "selective_scan_fwd": 2 * n["mamba"],
            "selective_scan_bwd": n["mamba"],
            "flash_attention_fwd": 2 * n["attn"],
            "flash_attention_bwd": n["attn"]}
    for name, progs in programs.items():
        for prog in progs:
            # training runs B8 at T 2048: its chunked route, never serial
            want[f"{name}_{prog}"] = 0 if prog == "serial" else want[name]
    losses, step_seconds = out["losses"], out["step_seconds"]
    warm = sorted(step_seconds[1:])
    warm_s = warm[len(warm) // 2]

    # one more warm step, outside the counted run, under the profiler
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 20, TRAIN_STEPS))
    step_batch = train_batch(cfg, seed, TRAIN_STEPS, batch=batch)
    split = device_split(lambda: train_step(model, out["state"]["opt"],
                                            step_batch, opt_cfg, remat=True))
    unmeasured = all(tuned.timer.n_measured == measured[name]
                     for name, tuned in tunes.items())
    ktune.disable()
    del out
    phase = "rwkv_train" if arch == RWKV_ARCH else "jamba_train"
    emit(phase=phase, ok=True, arch=arch, n_layers=cfg.n_layers,
         layer_kinds=list(kinds), moe=cfg.moe is not None,
         params=cfg.param_count(), batch=batch, seq_len=TRAIN_SEQ,
         steps=TRAIN_STEPS, remat=True, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, losses=losses,
         ln_vocab=math.log(cfg.vocab_size), step_seconds=step_seconds,
         warm_step_s=warm_s, tokens_per_s=batch * TRAIN_SEQ / warm_s,
         resolved=resolved, launches=launches, peak_gib=peak_gib,
         profiled_step=split)
    check(launches == want, f"{phase}: launches {launches}, want {want}")
    check(unmeasured, f"{phase}: the training path measured new "
                      "configurations")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"{phase}: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"{phase}: first loss {losses[0]}, ln V {math.log(cfg.vocab_size)}")
    return launches


# -- the other decoders (A4), the VLM and the encoder-decoder (A5) ----------------

@contextlib.contextmanager
def counted_measurements():
    """Counts the configurations ``KernelTimer`` measures inside it (the
    yielded dict's ``"n"``); serving must measure none."""
    from unittest import mock

    from repro_torch.tune.kernels.evaluate import KernelTimer

    measured = {"n": 0}
    real = KernelTimer._measure

    def measure(timer, cfg, key):
        measured["n"] += 1
        return real(timer, cfg, key)

    with mock.patch.object(KernelTimer, "_measure", measure):
        yield measured


def attention_fns() -> dict:
    """B3's, B4's and B5's kernel wrappers, whose ``launches`` count."""
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.flash_attention import kernel as fak

    return {"flash_attention_fwd": fak.flash_attention_fwd,
            "decode_attention": dak.decode_attention,
            "flash_attention_bwd": fak.flash_attention_bwd}


def zero_attention_counters() -> None:
    for fn in attention_fns().values():
        fn.launches = 0
    attention_fns()["flash_attention_bwd"].program_launches = {"dq": 0,
                                                               "dkv": 0}


def attention_launches() -> dict:
    fns = attention_fns()
    out = {name: fn.launches for name, fn in fns.items()}
    out.update({f"flash_attention_bwd_{p_}": n for p_, n in
                fns["flash_attention_bwd"].program_launches.items()})
    return out


def decoder_cfg(arch: str, n_layers: int | None = None,
                param_dtype: str | None = None):
    """``arch`` at full width, cut to its first ``n_layers`` (as
    ``ssm_cfg`` cuts Jamba) and built in ``param_dtype`` where given."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  layer_kinds=cfg.layer_kinds[:n_layers])
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    return cfg


def build_timed(cfg, seed: int):
    """(model cast for serving, build seconds, build peak GiB, GiB still
    allocated before the build)."""
    import gc

    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed).cast_for_serving()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    return model, build_s, peak, before


def serve_with_patches(model, tokens, patch_embeds, gen: int) -> dict:
    """The VLM path with its patches (the reference's prefill step,
    ``LM.prefill(patch_embeds=)``), then ``gen - 1`` greedy decode steps
    from position P + T; timed as ``serve_session`` times."""
    b = tokens.shape[0]
    n = tokens.shape[1] + patch_embeds.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(tokens, max_len=n + gen,
                                  patch_embeds=patch_embeds)
    last = logits[:, -1:].argmax(dim=-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [last]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, state = model.decode_step(state, last, n + i)
        last = logits[:, -1:].argmax(dim=-1)
        out.append(last)
    generated = torch.cat(out, dim=1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"generated": generated.cpu().numpy(), "prefill_s": prefill_s,
            "decode_s": decode_s,
            "tokens_per_s": b * (gen - 1) / max(decode_s, 1e-9)}


def moe_range():
    """Each MoE layer's call inside a profiler range named ``moe``."""
    from unittest import mock

    from torch.profiler import record_function

    from repro_torch.models import blocks

    real = blocks.apply_moe

    def apply_moe(p, h, cfg, **kw):
        with record_function("moe"):
            return real(p, h, cfg, **kw)

    return mock.patch.object(blocks, "apply_moe", apply_moe)


def serving_parity(model, prompt, generated, patch_embeds=None) -> dict:
    """``lm_parity``'s gate on a served decoder: the same weights with the
    kernels and with the plain versions, teacher-forced on the generated
    tokens, MoE choices pinned to the kernel run's; each step's largest
    logit difference at most 5 % of its largest logit."""
    import numpy as np

    feed = torch.as_tensor(generated, device="cuda")
    kern, routes, _ = teacher_forced(model, prompt, feed,
                                     patch_embeds=patch_embeds)
    plain, _, moved = teacher_forced(model, prompt, feed, plain_patches(),
                                     routes, patch_embeds=patch_embeds)
    rel = logit_gap(kern, plain)
    served = float(np.mean([
        float((step[:, -1].argmax(-1) == feed[:, i]).float().mean())
        for i, step in enumerate(kern)]))
    out = {"tolerance": 0.05, "steps": len(rel), "prefill_rel_err": rel[0],
           "decode_rel_err_max": max(rel[1:]),
           "decode_rel_err_mean": float(np.mean(rel[1:])),
           "argmax_agreement": float(np.mean([
               float((a.argmax(-1) == p.argmax(-1)).float().mean())
               for a, p in zip(kern, plain)])),
           "served_argmax_agreement": served, "choices_pinned": moved,
           "logit_abs_max": float(kern[0].abs().max()),
           "finite": bool(torch.isfinite(torch.stack(kern)).all()),
           "prefill_shape": list(kern[0].shape)}
    del kern, plain
    return out


def phase_decoder_serve(phase: str, arch: str, n_layers, param_dtype,
                        seed: int) -> dict:
    """One more decoder served at full width (cut in depth where it must
    fit the card): its launch counters go to 0 just before the entry point
    (``serve_session``; the VLM: ``LM.prefill(patch_embeds=)`` and the
    decode loop) and are read just after; no configuration is measured;
    then a profiled prefill and decode step, and ``serving_parity``."""
    from repro_torch.launch.serve import serve_session

    cfg = decoder_cfg(arch, n_layers, param_dtype)
    check(cfg.compute_dtype == "bfloat16", f"{arch} computes in "
                                           f"{cfg.compute_dtype}")
    vlm = cfg.frontend == "stub_patches"
    model, build_s, build_peak, before = build_timed(cfg, seed)
    patches = None
    if vlm:
        text = DEC_PROMPT - cfg.n_patches
        prompt = seed_prompt(cfg, seed, DEC_BATCH, text)
        gen = torch.Generator("cuda")
        gen.manual_seed(seed)
        patches = (torch.randn((DEC_BATCH, cfg.n_patches, cfg.d_model),
                               generator=gen, device="cuda") * 0.02)
    else:
        prompt = seed_prompt(cfg, seed, DEC_BATCH, DEC_PROMPT)
    n_attn = cfg.layer_kinds.count("attn")
    want = {"flash_attention_fwd": n_attn,
            "decode_attention": n_attn * (DEC_GEN - 1),
            "flash_attention_bwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    zero_attention_counters()
    with counted_measurements() as measured:
        if vlm:
            out = serve_with_patches(model, prompt, patches, DEC_GEN)
        else:
            out = serve_session(cfg, batch=DEC_BATCH, prompt_len=DEC_PROMPT,
                                gen=DEC_GEN, seed=seed, model=model)
    launches = attention_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == want, f"{phase}: launches {launches}, want {want}")
    check(measured["n"] == 0, f"{phase}: serving measured "
                              f"{measured['n']} configurations")
    generated = out["generated"]
    check(generated.shape == (DEC_BATCH, DEC_GEN)
          and ((0 <= generated) & (generated < cfg.vocab_size)).all(),
          f"{phase}: generated tokens {generated.shape}")
    if cfg.moe is not None:
        with moe_range():
            split = serve_split(model, prompt, DEC_GEN, patches,
                                ranges=("moe",))
    else:
        split = serve_split(model, prompt, DEC_GEN, patches)
    parity = serving_parity(model, prompt, generated, patches)
    emit(phase=phase, ok=True, arch=arch, n_layers=cfg.n_layers,
         param_dtype=cfg.param_dtype, batch=DEC_BATCH,
         prompt_len=DEC_PROMPT, patches=cfg.n_patches if vlm else 0,
         gen=DEC_GEN, params=sum(p.numel() for p in model.parameters()),
         build_s=build_s, build_peak_gib=build_peak,
         allocated_before_gib=before,
         prefill_s=out["prefill_s"], decode_s=out["decode_s"],
         tokens_per_s=out["tokens_per_s"], launches=launches,
         measured=measured["n"], peak_gib=peak_gib, profiled=split,
         parity=parity, first_tokens=generated[:, :8].tolist())
    check(parity["finite"], f"{phase}: non-finite logits")
    check(parity["prefill_shape"] == [DEC_BATCH, 1, cfg.vocab_size],
          f"{phase}: prefill logits {parity['prefill_shape']}")
    check(max(parity["prefill_rel_err"], parity["decode_rel_err_max"])
          <= 0.05, f"{phase}: relative logit error {parity}")
    del model, out
    torch.cuda.empty_cache()
    return launches


def whisper_frames(cfg, seed: int, batch: int, n: int) -> torch.Tensor:
    """The frames ``serve_session`` draws for an encoder-decoder: after the
    prompt tokens, from the same ``default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab_size, (batch, n))
    return torch.as_tensor(rng.standard_normal((batch, n, cfg.d_model))
                           .astype(np.float32) * np.float32(0.02),
                           device="cuda")


def checked_attention(seen: dict):
    """Patches running every B3, B4 and B5 call's plain version on the same
    inputs beside it, each result appended to ``seen[name]`` with its
    shape and gap (``attention_parity``'s gates: B3 2e-2 in bf16 and 2e-4
    in float32, lse 1e-3; B4 2e-4; B5 2e-2 of the largest |grad| in bf16,
    2e-4 in float32)."""
    from unittest import mock

    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def fwd(q, k, v, *, causal, q_offset, **launch):
        o, lse = fak.flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=q_offset, **launch)
        o_p, lse_p = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   q_offset=q_offset)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-4
        seen.setdefault("flash_attention_fwd", []).append({
            "tq": q.shape[1], "tk": k.shape[1], "causal": causal,
            "max_abs_err": float_err(o, o_p),
            "lse_max_abs_err": float_err(lse, lse_p),
            "ok": torch.allclose(o.float(), o_p.float(), atol=tol, rtol=tol)
            and torch.allclose(lse, lse_p, atol=1e-3, rtol=1e-3)})
        return o, lse

    def bwd(q, k, v, o, lse, do, *, causal, q_offset, **launch):
        got = fak.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      q_offset=q_offset, **launch)
        want = fak.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal, q_offset=q_offset)
        err = max(grad_err(g, w) for g, w in zip(got, want))
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-4
        seen.setdefault("flash_attention_bwd", []).append({
            "tq": q.shape[1], "tk": k.shape[1], "causal": causal,
            "rel_err": err, "ok": err <= tol})
        return got

    def decode(q, k, v, length, **launch):
        got = dak.decode_attention(q, k, v, length, **launch)
        want = dak.decode_attention_plain(q, k, v, length)
        seen.setdefault("decode_attention", []).append({
            "cache": k.shape[1], "length": length,
            "max_abs_err": float_err(got, want),
            "ok": torch.allclose(got, want, atol=2e-4, rtol=2e-4)})
        return got

    return [mock.patch.object(fa_ops, "flash_attention_fwd", fwd),
            mock.patch.object(fa_ops, "flash_attention_bwd", bwd),
            mock.patch.object(da_ops, "decode_attention_kernel", decode)]


def summarize_calls(seen: dict, phase: str) -> dict:
    """Each kernel's checked calls grouped by shape: how many, the worst
    gap; fails the phase on any call over its gate."""
    out = {}
    for name, calls in seen.items():
        bad = [c for c in calls if not c["ok"]]
        check(not bad, f"{phase}: {name} disagrees with its plain version "
                       f"in {len(bad)} of {len(calls)} calls, first "
                       f"{bad[:1]}")
        groups: dict = {}
        for c in calls:
            key = (f"cache {c['cache']}" if "cache" in c else
                   f"{c['tq']}x{c['tk']} {'causal' if c['causal'] else 'full'}")
            g = groups.setdefault(key, {"calls": 0, "max_err": 0.0})
            g["calls"] += 1
            g["max_err"] = max(g["max_err"], c.get("max_abs_err",
                                                   c.get("rel_err", 0.0)))
        out[name] = groups
    return out


def whisper_teacher_forced(model, frames, feed, patches=()) -> list:
    """``prefill_cross`` on ``frames``, then the decoder fed ``feed`` (the
    served tokens, all but the last) from position 0; each step's logits."""

    b, n = frames.shape[:2]
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        state = model.init_decode_state(b, n + feed.shape[1], cross_len=n)
        state = model.prefill_cross(state, frames)
        steps = []
        for i in range(feed.shape[1] - 1):
            logits, state = model.decode_step(state, feed[:, i:i + 1], i)
            steps.append(logits)
    del state
    return steps


def phase_whisper_serve(seed: int) -> dict:
    """The encoder-decoder served: its launch counters go to 0 just before
    ``serve_session`` and are read just after (B3 once an encoder layer;
    B4 twice a decoder layer and step: self-attention, and cross-attention
    over the whole encoder cache, ``length=None``); no configuration is
    measured; a profiled encoder pass and decode step; then the served
    tokens teacher-forced with every B3/B4 call held against its plain
    version, and the logits against a run through the plain versions
    (5 %)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import serve_session

    cfg = configs.get(WHISPER_ARCH)
    b, n, gen = WHISPER_BATCH, WHISPER_FRAMES, WHISPER_GEN
    model, build_s, build_peak, before = build_timed(cfg, seed)
    want = {"flash_attention_fwd": cfg.n_encoder_layers,
            "decode_attention": 2 * cfg.n_layers * (gen - 1),
            "flash_attention_bwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    zero_attention_counters()
    with counted_measurements() as measured:
        out = serve_session(cfg, batch=b, prompt_len=n, gen=gen, seed=seed,
                            model=model)
    launches = attention_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == want, f"whisper_serve: launches {launches}, want "
                            f"{want}")
    check(measured["n"] == 0, f"whisper_serve: serving measured "
                              f"{measured['n']} configurations")
    generated = out["generated"]
    check(generated.shape == (b, gen) and (generated[:, 0] == 0).all()
          and ((0 <= generated) & (generated < cfg.vocab_size)).all(),
          f"whisper_serve: generated tokens {generated.shape}")

    frames = whisper_frames(cfg, seed, b, n)
    state = model.prefill_cross(
        model.init_decode_state(b, n + gen, cross_len=n), frames)
    tok = torch.zeros((b, 1), dtype=torch.int64, device="cuda")

    def encode():
        model.prefill_cross(state, frames)

    def decode():
        model.decode_step(state, tok, gen - 1)

    split = {}
    for label, fn in (("prefill_cross", encode), ("decode_step", decode)):
        fn()
        row = device_split(fn)
        split[label] = {k: row[k] for k in ("wall_ms", "device_busy_ms",
                                            "idle_share", "device_launches",
                                            "split_ms")}
        split[label]["top"] = row["top"][:6]
    del state

    feed = torch.as_tensor(generated, device="cuda")
    seen: dict = {}
    kern = whisper_teacher_forced(model, frames, feed,
                                  checked_attention(seen))
    plain = whisper_teacher_forced(model, frames, feed, plain_patches())
    calls = summarize_calls(seen, "whisper_serve")
    cross = [c for c in seen["decode_attention"] if c["cache"] == n]
    check(len(cross) == cfg.n_layers * (gen - 1)
          and all(c["length"] == n for c in cross),
          f"whisper_serve: {len(cross)} cross-attention decode calls over "
          "the whole encoder cache")
    rel = logit_gap(kern, plain)
    served = float(np.mean([
        float((step[:, -1].argmax(-1) == feed[:, i + 1]).float().mean())
        for i, step in enumerate(kern)]))
    parity = {"tolerance": 0.05, "steps": len(rel),
              "rel_err_max": max(rel), "rel_err_mean": float(np.mean(rel)),
              "argmax_agreement": float(np.mean([
                  float((a.argmax(-1) == p.argmax(-1)).float().mean())
                  for a, p in zip(kern, plain)])),
              "served_argmax_agreement": served,
              "logit_abs_max": float(kern[0].abs().max()),
              "kernel_calls": calls}
    finite = bool(torch.isfinite(torch.stack(kern)).all())
    shape = tuple(kern[0].shape)
    del kern, plain
    emit(phase="whisper_serve", ok=True, arch=WHISPER_ARCH,
         n_encoder_layers=cfg.n_encoder_layers, n_layers=cfg.n_layers,
         batch=b, frames=n, gen=gen,
         params=sum(p.numel() for p in model.parameters()),
         build_s=build_s, build_peak_gib=build_peak,
         allocated_before_gib=before,
         prefill_s=out["prefill_s"], decode_s=out["decode_s"],
         tokens_per_s=out["tokens_per_s"], launches=launches,
         measured=measured["n"], peak_gib=peak_gib, profiled=split,
         parity=parity, first_tokens=generated[:, :8].tolist())
    check(finite, "whisper_serve: non-finite logits")
    check(shape == (b, 1, cfg.vocab_size),
          f"whisper_serve: decode logits {shape}")
    check(max(rel) <= 0.05, f"whisper_serve: relative logit error "
                            f"{max(rel)}")
    del model
    torch.cuda.empty_cache()
    return launches


def whisper_grads(model, batch, phase: str, checked: bool):
    """``lm_grads`` of ``model`` with the kernels, every B3/B5 call then
    held against its plain version (``checked``), or with the plain
    versions; returns (loss, grads, the checked calls' summary)."""

    if not checked:
        loss, grads = lm_grads(model, batch, plain_attention_fwd,
                               plain_attention_bwd)
        return loss, grads, None
    seen: dict = {}
    with contextlib.ExitStack() as stack:
        for patch in checked_attention(seen):
            stack.enter_context(patch)
        loss, grads = lm_grads(model, batch)
    cfg = model.cfg
    cross = [c for c in seen["flash_attention_bwd"]
             if (c["tq"], c["tk"]) == (cfg.decoder_len, WHISPER_FRAMES)]
    check(len(cross) == cfg.n_layers,
          f"{phase}: {len(cross)} cross-attention backward calls")
    return loss, grads, summarize_calls(seen, phase)


def phase_whisper_train(seed: int) -> dict:
    """The encoder-decoder trained at full size (float32 parameters and
    AdamW, bf16 compute, each layer recomputed in the backward pass).

    First its gradient parity, every B3 and B5 call of the kernel passes
    held against its plain version on the same inputs (the
    cross-attention's 448 queries over 1500 keys among them):
    ``lm_train_parity``'s gates, the loss within 1 % and each parameter's
    gradient within ``GRAD_GATE`` relative L2 of the plain versions', held
    in float32 compute (TF32 off), where they measure the kernels.  In
    bf16 the cross-attention's query and key gradients are rounding noise
    at random weights (its attention is near-uniform over 1500 keys, so
    ``dp - delta`` cancels: the plain versions' own bf16 gradients of
    ``cross.wq``/``wk`` and ``norm_x`` lie 3-6x their norm from float32, on
    the CPU too), so the bf16 pass holds each parameter's distance from
    the float32 plain gradient to the larger of ``GRAD_GATE`` and 1.5x
    the plain bf16 pass's largest distance over that parameter's leaves
    (``leaf_gates``), and reports the direct bf16 gap.

    Then its launch counters go to 0 just before ``train_loop`` and are
    read just after: a step runs 18 attentions (6 encoder, 6 decoder self,
    6 cross), B3 twice each under remat, each B5 program once."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine

    cfg = configs.get(WHISPER_ARCH)
    b, n, steps = WHISPER_BATCH, WHISPER_FRAMES, WHISPER_TRAIN_STEPS
    batch = train_batch(cfg, seed, batch=b, seq=n)
    check(batch["frame_embeds"].shape == (b, n, cfg.d_model)
          and batch["tokens"].shape == (b, cfg.decoder_len),
          f"whisper_train: batch {[tuple(v.shape) for v in batch.values()]}")

    # float32 compute: the gates
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          seed=seed)
    loss32_k, grads32_k, calls32 = whisper_grads(model32, batch,
                                                 "whisper_train", True)
    loss32_p, grads32_p, _ = whisper_grads(model32, batch, "whisper_train",
                                           False)
    del model32
    finite = all(bool(torch.isfinite(g).all()) for g in grads32_k.values())
    gaps32 = grad_gaps(grads32_k, grads32_p)
    loss32_rel = float((loss32_k - loss32_p).abs() / loss32_p.abs())
    del grads32_k

    # bf16 compute, as trained: each pass against the float32 plain one
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    loss_k, grads_k, calls = whisper_grads(model, batch, "whisper_train",
                                           True)
    loss_p, grads_p, _ = whisper_grads(model, batch, "whisper_train", False)
    finite = finite and all(bool(torch.isfinite(g).all())
                            for g in grads_k.values())
    gaps = grad_gaps(grads_k, grads_p)
    rel_k = rel_l2_leaves(grads_k, grads32_p)
    rel_p = rel_l2_leaves(grads_p, grads32_p)
    gates = leaf_gates(rel_p, floor=GRAD_GATE)
    over = over_gate(rel_k, gates)
    loss_rel = float((loss_k - loss_p).abs() / loss_p.abs())
    del grads_k, grads_p, grads32_p
    torch.cuda.empty_cache()
    parity = {
        "float32": {"loss_kernels": float(loss32_k),
                    "loss_plain": float(loss32_p),
                    "loss_rel_err": loss32_rel,
                    "grad_rel_l2_max": gaps32["max"],
                    "grad_rel_l2_worst": gaps32["worst"],
                    "grad_rel_l2_mean": gaps32["mean"],
                    "tolerance": GRAD_GATE, "kernel_calls": calls32},
        "bfloat16": {"loss_kernels": float(loss_k),
                     "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
                     "grad_rel_l2_max": gaps["max"],
                     "grad_rel_l2_worst": gaps["worst"],
                     "grad_rel_l2_mean": gaps["mean"],
                     "kernels_vs_float32": summary(rel_k),
                     "plain_vs_float32": summary(rel_p),
                     "over_gate": over, "kernel_calls": calls}}
    emit(phase="whisper_train_parity", arch=WHISPER_ARCH, batch=b, frames=n,
         tokens=cfg.decoder_len, remat=True, **parity)
    check(finite and bool(torch.isfinite(loss_k)),
          "whisper_train: non-finite loss or gradient")
    check(loss32_rel <= 0.01 and loss_rel <= 0.01,
          f"whisper_train: losses {parity}")
    check(max(gaps32["max"].values()) <= GRAD_GATE,
          f"whisper_train: float32 gradients {gaps32}")
    check(not over, f"whisper_train: bf16 gradients over their gates {over}")

    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    want = {"flash_attention_fwd": 2 * n_attn * steps,
            "decode_attention": 0,
            "flash_attention_bwd": n_attn * steps,
            "flash_attention_bwd_dq": n_attn * steps,
            "flash_attention_bwd_dkv": n_attn * steps}
    zero_attention_counters()
    out = train_loop(cfg, steps_total=steps, batch=b, seq_len=n, seed=seed,
                     remat=True, log_every=0, model=model)
    launches = attention_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    warm = sorted(out["step_seconds"][1:])
    warm_s = warm[len(warm) // 2]
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 20, steps))
    split = device_split(lambda: train_step(
        model, out["state"]["opt"], train_batch(cfg, seed, steps, b, n),
        opt_cfg, remat=True))
    emit(phase="whisper_train", ok=True, arch=WHISPER_ARCH, batch=b,
         frames=n, tokens=cfg.decoder_len, steps=steps, remat=True,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         params=sum(p.numel() for p in model.parameters()), build_s=build_s,
         losses=losses, ln_vocab=math.log(cfg.vocab_size),
         step_seconds=out["step_seconds"], warm_step_s=warm_s,
         decoder_tokens_per_s=b * cfg.decoder_len / warm_s,
         frames_per_s=b * n / warm_s, launches=launches, peak_gib=peak_gib,
         profiled_step=split)
    check(launches == want, f"whisper_train: launches {launches}, want "
                            f"{want}")
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"whisper_train: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"whisper_train: first loss {losses[0]}, ln V "
          f"{math.log(cfg.vocab_size)}")
    del model, out
    torch.cuda.empty_cache()
    return launches


# -- A6: ranks on the one card (dist/) ---------------------------------------------
#
# The ranks are processes spawned from this script after the build (they load
# the built libraries from build/ and build nothing), joined by gloo through
# a file rendezvous: NCCL refuses two ranks on one device.  Each rank writes
# its JSON (launch counters zeroed just before its entry point and read just
# after, its times, its peak GiB) for the parent to emit and check.  Two
# ranks time-slice one card: their times say nothing about two cards.

RANK_TIMEOUT_S = 300.0
# B4 alone over stripes: Qwen2.5-3B's decode heads, a 32768 cache, B 8
SEQ_B, SEQ_CACHE, SEQ_POSITIONS = 8, 32768, (37, 16383, 16384, 32767)
# Qwen2.5-3B served with the cache in two stripes: batch 1, 16384 prompt
SEQ_SERVE_PROMPT, SEQ_SERVE_GEN = 16384, 16
# Qwen2.5-3B cut to 2 of 36 layers trained data-parallel: 4 x 2048, 2 steps
# (the embedding is half of 4 layers' gradient, and each step's float32
# all-reduce goes through gloo on the host)
DP_LAYERS, DP_BATCH, DP_SEQ, DP_STEPS = 2, 4, 2048, 2
ALLREDUCE_N = 2 ** 20
# A6b: Qwen2.5-3B served with its heads over two ranks (a (1, 2) mesh, each
# rank 8 q heads over 1 kv head); Qwen2-MoE at full width, cut to
# SHARDED_LAYERS of 24 (a step of 2 layers moved 44.6 GB a rank through
# gloo in 47 s), trained on a (2, 2) mesh (TP, 30 experts a rank, FSDP
# over data, seq_parallel, 2 microbatches, remat), float32
TP_BATCH, TP_PROMPT, TP_GEN = 4, 1024, 16
SHARDED_ARCH, SHARDED_LAYERS = "qwen2-moe-a2.7b", 1
SHARDED_BATCH, SHARDED_SEQ, SHARDED_STEPS = 4, 512, 2


def rank_main(rank: int, world: int, init_file: str, jobs,
              out_dir: str) -> None:
    """One rank: join the group, then for each job ``(fn, shape, axes,
    args)`` make the mesh, run ``fn(rank, mesh, *args)`` and write what it
    returns (a dict, with the job's peak GiB) as JSON."""
    import gc

    import torch.distributed as dist

    from repro_torch.dist.ranks import init_ranks
    from repro_torch.launch.mesh import make_host_mesh

    backend = init_ranks(rank, world, init_method=f"file://{init_file}",
                         device_type="cuda", timeout_s=RANK_TIMEOUT_S)
    try:
        for j, (fn, shape, axes, args) in enumerate(jobs):
            mesh = make_host_mesh(axes=tuple(axes), shape=tuple(shape))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out = fn(rank, mesh, *args)
            out.update(rank=rank, backend=backend,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       imports_jax="jax" in sys.modules,
                       imports_repro="repro" in sys.modules)
            (Path(out_dir) / f"job{j}_rank{rank}.json").write_text(
                json.dumps(out))
            del out
    finally:
        dist.destroy_process_group()


def spawn_jobs(world: int, jobs: list) -> list[list[dict]]:
    """``world`` ranks on the card that run ``jobs`` (``(fn, shape, axes,
    args)`` each) one after another, on one process group: a spawned rank
    takes ~9 s to import and reach the card, so the paths of one rank
    count share it.  Each job's JSON in rank order, by job.  A rank that
    raises, or a run past ``RANK_TIMEOUT_S`` a job, fails the phase."""
    import gc

    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    names = [fn.__name__ for fn, *_ in jobs]
    timeout = RANK_TIMEOUT_S * len(jobs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        ctx = mp.start_processes(
            rank_main, args=(world, str(Path(tmp) / "rendezvous"), jobs,
                             tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                check(time.monotonic() < deadline,
                      f"{names}: {world} ranks past {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        out = [[json.loads((Path(tmp) / f"job{j}_rank{r}.json").read_text())
                for r in range(world)] for j in range(len(jobs))]
    for name, ranks in zip(names, out):
        for r in ranks:
            check(not (r["imports_jax"] or r["imports_repro"]),
                  f"{name}: rank {r['rank']} imported jax or repro")
    return out


def rank_seq_decode(rank: int, mesh, kv_shard: str, seed: int,
                    allreduce: bool) -> dict:
    """B4 over this rank's stripe (and rows) of a seeded cache through
    ``seq_decode_attention`` at every position of ``SEQ_POSITIONS``, bf16
    and float32; each against B4 and ``decode_attention_plain`` over the
    whole updated cache in this process, the stripe's lse against the
    plain lse, the stripe against the whole cache's, and the B4 launches
    of the call (0 on an empty stripe).  With ``allreduce`` also the
    compressed all-reduce on this mesh."""
    from repro_torch.dist.collectives import COUNTERS
    from repro_torch.dist.seq_decode import seq_decode_attention
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention import ops as da_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rules = ShardingConfig(data_axes=("data",), model_axes=("model",),
                           kv_shard=kv_shard).rules(mesh)
    seq, bax = rules.axes("kv_seq"), rules.axes("batch")
    kv, rep, hd = 2, 8, 128                       # Qwen2.5-3B's decode heads
    bl = SEQ_B // mesh.axes_size(bax)
    sl = SEQ_CACHE // mesh.axes_size(seq)
    b0, s0 = mesh.index(bax) * bl, mesh.index(seq) * sl
    rows = slice(b0, b0 + bl)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator("cuda")
        gen.manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, kn, vn = randn(SEQ_B, kv * rep, hd), randn(SEQ_B, kv, hd), \
            randn(SEQ_B, kv, hd)
        ck, cv = randn(SEQ_B, SEQ_CACHE, kv, hd), randn(SEQ_B, SEQ_CACHE,
                                                       kv, hd)
        for pos in SEQ_POSITIONS:
            lk = ck[rows, s0:s0 + sl].clone()
            lv = cv[rows, s0:s0 + sl].clone()
            torch.cuda.synchronize()
            dak.decode_attention.launches = 0
            COUNTERS.reset()
            t0 = time.perf_counter()
            out, lk, lv = seq_decode_attention(
                q[rows], kn[rows], vn[rows], lk, lv, pos, mesh=mesh,
                seq_axes=seq, batch_axes=bax)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            totals = collective_totals(COUNTERS.snapshot())
            launches = dak.decode_attention.launches
            fk, fv = ck.clone(), cv.clone()
            fk[:, pos], fv[:, pos] = kn, vn
            whole = da_ops.decode_attention(q, fk, fv, length=pos + 1)[rows]
            plain = dak.decode_attention_plain(
                q.view(SEQ_B, kv, rep, hd), fk, fv, pos + 1).view(
                    SEQ_B, kv * rep, hd)[rows]
            n = min(pos + 1 - s0, sl)
            lse_err = None
            if n >= 1:
                _, lse = da_ops.decode_attention(q[rows], lk, lv, length=n,
                                                 return_lse=True)
                _, lse_p = dak.decode_attention_plain(
                    q[rows].view(bl, kv, rep, hd), lk, lv, n,
                    return_lse=True)
                lse_err = float_err(lse, lse_p)
            case = {"dtype": str(dtype).split(".")[-1], "pos": pos,
                    "stripe_len": n if n >= 1 else 0,
                    "launches": launches, "want_launches": int(n >= 1),
                    "err_vs_b4": float_err(out, whole),
                    "err_vs_plain": float_err(out, plain),
                    "lse_err": lse_err,
                    "stripe_equal": torch.equal(lk, fk[rows, s0:s0 + sl])
                    and torch.equal(lv, fv[rows, s0:s0 + sl]),
                    "step_ms": step_ms,
                    "collective_calls": totals["collective_calls"],
                    "collective_bytes": totals["collective_bytes"]}
            case["ok"] = (case["launches"] == case["want_launches"]
                          and case["err_vs_b4"] <= 2e-4
                          and case["err_vs_plain"] <= 2e-4
                          and (lse_err is None or lse_err <= 1e-4)
                          and case["stripe_equal"])
            cases.append(case)
            del fk, fv
        del q, kn, vn, ck, cv
    out = {"kv_shard": kv_shard, "mesh": mesh.shape, "b0": b0, "s0": s0,
           "cases": cases}
    if allreduce:
        out["allreduce"] = rank_allreduce(rank, mesh, seed)
    return out


def rank_allreduce(rank: int, mesh, seed: int) -> dict:
    """``compressed_allreduce_mean`` of one row of 2^20 float32 a rank:
    int8 within max|x| / 100 of the true mean (the reference's gate), top-k
    0.25 equal to the mean of each rank's decompressed top-k."""
    from repro_torch.dist.compression import (CompressionConfig,
                                              _compress_leaf,
                                              compressed_allreduce_mean)

    world = mesh.shape["data"]
    gen = torch.Generator("cuda")
    gen.manual_seed(seed + 1)
    x_all = torch.randn((world, ALLREDUCE_N), generator=gen, device="cuda")
    x = x_all[rank:rank + 1]
    out = {}
    for scheme in ("int8", "topk"):
        compressed_allreduce_mean(x, mesh, "data", scheme=scheme)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = compressed_allreduce_mean(x, mesh, "data", scheme=scheme)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cfg = CompressionConfig(scheme=scheme)
        want = torch.stack([_compress_leaf(x_all[r:r + 1], cfg)
                            for r in range(world)]).mean(0)
        # one all-reduce of the decompressed float32 contribution a call
        # (compression.compressed_allreduce_mean calls dist.all_reduce)
        out[scheme] = {"ms": ms, "collective_calls": 1,
                       "collective_bytes": x.numel() * 4,
                       "err_vs_compressed_mean":
                       float_err(got, want),
                       "err_vs_mean": float_err(got, x_all.mean(0,
                                                                keepdim=True)),
                       "gate_int8": float(x_all.abs().max()) / 100}
    out["ok"] = (out["int8"]["err_vs_mean"] < out["int8"]["gate_int8"]
                 and out["int8"]["err_vs_compressed_mean"] <= 1e-6
                 and out["topk"]["err_vs_compressed_mean"] <= 1e-6)
    return out


def phase_seq_decode_parity(two: list[dict], four: list[dict]) -> None:
    """B4 over stripes on two ranks (``kv_shard="seq"``, the batch on
    both; with them the compressed all-reduce) and on a (2, 2) mesh of
    four (``"batch_seq"``): ``rank_seq_decode``'s results."""
    for r in two + four:
        emit(phase="seq_decode_parity", **{k: v for k, v in r.items()
                                           if k != "allreduce"})
        check(all(c["ok"] for c in r["cases"]),
              f"seq_decode_parity: rank {r['rank']} of {r['mesh']}: "
              f"{[c for c in r['cases'] if not c['ok']]}")


def phase_compressed_allreduce(two: list[dict], cfg) -> None:
    """The compressed all-reduce's results (from ``seq_decode_parity``'s
    two ranks) and the bytes a step of ``dp_train``'s gradients would put
    on the wire under each scheme, the reference's stacked leaves each one
    tensor."""
    from repro_torch.dist.compression import (CompressionConfig,
                                              stack_groups, wire_bytes)
    from repro_torch.models import build_model

    params = dict(build_model(cfg, device="meta").named_parameters())
    groups = stack_groups(params, len(cfg.group_pattern))
    stacked = {k: torch.empty((len(ns), *params[ns[0]].shape),
                              device="meta") for k, ns in groups.items()}
    wire = {scheme: wire_bytes(stacked, CompressionConfig(scheme))
            for scheme in ("none", "int8", "topk")}
    for r in two:
        emit(phase="compressed_allreduce", rank=r["rank"], n=ALLREDUCE_N,
             backend=r["backend"], **r["allreduce"],
             dp_train_wire_bytes=wire)
        check(r["allreduce"]["ok"], f"compressed_allreduce: {r['allreduce']}")


def rank_seq_serve(rank: int, mesh, seed: int) -> dict:
    """Qwen2.5-3B served with each attention cache in two stripes: the
    launch counters go to 0 just before ``serve_session`` and are read just
    after; then a profiled decode step (both ranks) for the combine's
    share, and on rank 0 the same weights teacher-forced on the tokens in
    one process with the whole cache."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.dist.api import use_rules
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.serve import serve_session

    cfg = configs.get(LM_ARCH)
    scfg = ShardingConfig(data_axes=("data",), model_axes=(),
                          kv_shard="seq")
    from repro_torch.dist.collectives import COUNTERS

    model, build_s, build_peak, _ = build_timed(cfg, seed)
    zero_attention_counters()
    COUNTERS.reset()
    with counted_measurements() as measured:
        out = serve_session(cfg, batch=1, prompt_len=SEQ_SERVE_PROMPT,
                            gen=SEQ_SERVE_GEN, seed=seed, model=model,
                            scfg=scfg, mesh=mesh, return_logits=True)
    launches = attention_launches()
    session = collective_totals(COUNTERS.snapshot())
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    uncounted = uncounted_session(lambda: serve_session(
        cfg, batch=1, prompt_len=SEQ_SERVE_PROMPT, gen=SEQ_SERVE_GEN,
        seed=seed, model=model, scfg=scfg, mesh=mesh), SEQ_SERVE_GEN)

    # one decode step under the profiler, every rank (the collectives
    # need them all): a short prompt prefilled into the same stripes, the
    # step at a position whose stripes are both long
    max_len = SEQ_SERVE_PROMPT + SEQ_SERVE_GEN
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, SEQ_SERVE_PROMPT)), device="cuda")
    with use_rules(scfg.rules(mesh)), torch.inference_mode():
        _, state = model.prefill(prompt[:, :1024], max_len=max_len)
        tok = prompt[:, :1]
        model.decode_step(state, tok, SEQ_SERVE_PROMPT - 1)
        torch.cuda.synchronize()
        # the card's activity traced by rank 0 alone; the combine is host
        # time (gloo), read on both
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if rank == 0 else [])) as prof:
            t0 = time.perf_counter()
            model.decode_step(state, tok, SEQ_SERVE_PROMPT - 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        del state
    combine = [e for e in prof.key_averages()
               if e.key == "seq_decode_combine"
               and "cuda" not in str(e.device_type).lower()]
    combine_ms = sum(e.cpu_time_total for e in combine) / 1e3
    busy_ms = sum(device_time_us(e) for e in prof.key_averages()
                  if "cuda" in str(e.device_type).lower()) / 1e3
    result = {"params": sum(p.numel() for p in model.parameters()),
              "build_s": build_s, "build_peak_gib": build_peak,
              "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
              "tokens_per_s": out["tokens_per_s"], "launches": launches,
              "measured": measured["n"], "serve_peak_gib": serve_peak,
              "session": {**session, "collective_calls_per_token":
                          session["collective_calls"] / SEQ_SERVE_GEN,
                          "collective_bytes_per_token":
                          session["collective_bytes"] / SEQ_SERVE_GEN},
              "uncounted": uncounted,
              "generated": out["generated"].tolist(),
              "profiled_step": {"wall_ms": wall_ms, "combine_ms": combine_ms,
                                "combine_calls": sum(e.count
                                                     for e in combine),
                                "combine_share": combine_ms / wall_ms,
                                "device_busy_ms": busy_ms if rank == 0
                                else "not measured"}}
    if rank == 0:
        feed = torch.as_tensor(out["generated"], device="cuda")
        whole, _, _ = teacher_forced(model, prompt, feed)
        rel = logit_gap([g.cuda() for g in out["logits"]], whole)
        result["parity"] = {"steps": len(rel), "rel_err_max": max(rel),
                            "prefill_rel_err": rel[0],
                            "finite": all(bool(torch.isfinite(g).all())
                                          for g in out["logits"])}
    return result


def phase_seq_serve(ranks: list[dict]) -> dict:
    """Two ranks serve Qwen2.5-3B with the sequence-sharded decode
    (``rank_seq_serve``'s results)."""
    from repro_torch import configs

    cfg = configs.get(LM_ARCH)
    want = {"flash_attention_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * (SEQ_SERVE_GEN - 1),
            "flash_attention_bwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    for r in ranks:
        emit(phase="seq_serve", arch=LM_ARCH, batch=1,
             prompt_len=SEQ_SERVE_PROMPT, gen=SEQ_SERVE_GEN,
             max_len=SEQ_SERVE_PROMPT + SEQ_SERVE_GEN,
             stripe=(SEQ_SERVE_PROMPT + SEQ_SERVE_GEN) // 2,
             **{k: v for k, v in r.items() if k != "generated"},
             first_tokens=r["generated"][0][:8])
        check(r["launches"] == want, f"seq_serve: rank {r['rank']} "
                                     f"launches {r['launches']}, want {want}")
        check(r["measured"] == 0, f"seq_serve: rank {r['rank']} measured "
                                  f"{r['measured']} configurations")
    check(ranks[0]["generated"] == ranks[1]["generated"],
          "seq_serve: the ranks' tokens differ")
    parity = ranks[0]["parity"]
    check(parity["finite"] and parity["rel_err_max"] <= 0.05,
          f"seq_serve: logits vs the one-process run {parity}")
    return {name: sum(r["launches"][name] for r in ranks)
            for name in want}


def dp_cfg(compute_dtype: str | None = None):
    """Qwen2.5-3B at full width cut to ``DP_LAYERS`` layers."""
    import dataclasses

    cfg = decoder_cfg(LM_ARCH, DP_LAYERS)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return cfg


def dp_run(cfg, seed: int, mesh=None, compression: str = "none") -> dict:
    """``train_loop`` of ``cfg`` (remat) on the global batch; its losses,
    step and all-reduce seconds and attention launches (counters zeroed
    just before it, read just after)."""
    import gc

    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.train import train_loop

    from repro_torch.dist.collectives import COUNTERS

    scfg = ShardingConfig(data_axes=("data",), model_axes=(), remat=True,
                          grad_compression=compression)
    zero_attention_counters()
    COUNTERS.reset()
    out = train_loop(cfg, steps_total=DP_STEPS, batch=DP_BATCH,
                     seq_len=DP_SEQ, seed=seed, log_every=0, scfg=scfg,
                     mesh=mesh)
    launches = attention_launches()
    totals = collective_totals(COUNTERS.snapshot())
    result = {"compute_dtype": cfg.compute_dtype, "compression": compression,
              "losses": out["losses"], "step_seconds": out["step_seconds"],
              "allreduce_seconds": out["allreduce_seconds"],
              "collective_calls_per_step":
                  totals["collective_calls"] / DP_STEPS,
              "collective_bytes_per_step":
                  totals["collective_bytes"] / DP_STEPS,
              "launches": launches}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return result


def rank_dp_train(rank: int, mesh, seed: int) -> dict:
    """Three data-parallel runs on this rank's half of each step's rows:
    float32 compute with TF32 off (the gate), then bf16 without and with
    int8 gradient compression."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"runs": [dp_run(dp_cfg("float32"), seed, mesh),
                     dp_run(dp_cfg(), seed, mesh),
                     dp_run(dp_cfg(), seed, mesh, "int8")]}


def dp_one_process(seed: int) -> dict:
    """``dp_train``'s float32 run in one process (this one), which its
    ranks are held to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dp_run(dp_cfg("float32"), seed)


def phase_dp_train(one: dict, ranks: list[dict]) -> dict:
    """One rank (this process, ``dp_one_process``) and two ranks
    (``rank_dp_train``) of the same global batch."""
    n = DP_LAYERS * DP_STEPS
    want = {"flash_attention_fwd": 2 * n, "decode_attention": 0,
            "flash_attention_bwd": n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n}
    emit(phase="dp_train", ranks=1, arch=LM_ARCH, n_layers=DP_LAYERS,
         batch=DP_BATCH, seq_len=DP_SEQ, **one)
    for r in ranks:
        emit(phase="dp_train", ranks=2, arch=LM_ARCH, n_layers=DP_LAYERS,
             batch=DP_BATCH, seq_len=DP_SEQ, **r)
        f32, bf16, int8 = r["runs"]
        rel = [abs(a - b) / abs(b) for a, b in zip(f32["losses"],
                                                    one["losses"])]
        check(len(rel) == DP_STEPS and max(rel) <= 2e-4,
              f"dp_train: rank {r['rank']} float32 losses {f32['losses']} "
              f"vs one rank {one['losses']}")
        finals = (bf16["losses"][-1], int8["losses"][-1])
        check(all(map(math.isfinite, finals))
              and abs(finals[0] - finals[1]) < 0.1,
              f"dp_train: bf16 final losses {finals}")
        for run in r["runs"]:
            check(run["launches"] == want,
                  f"dp_train: rank {r['rank']} {run['compute_dtype']} "
                  f"{run['compression']}: launches {run['launches']}")
    return {name: sum(run["launches"][name] for r in ranks
                      for run in r["runs"]) for name in want}


# -- A6b: tensor, expert and FSDP parameter sharding, ranks sharing the card

def nbytes(tree) -> int:
    """The bytes of a tensor, or of every tensor of a dict or an iterable
    of them (nested)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(nbytes(t) for t in tree)


def collective_totals(counts: dict) -> dict:
    """The collectives' counters (``dist.collectives.COUNTERS``) summed."""
    return {f"collective_{k}": sum(v[k] for v in counts.values())
            for k in ("calls", "bytes", "seconds")}


def counted_step(fn):
    """``fn()`` with the collectives' counters reset just before it and
    read just after, each collective between two synchronizes; (result,
    {wall seconds, counters by op and axes, their sums})."""
    from repro_torch.dist.collectives import COUNTERS

    torch.cuda.synchronize()
    COUNTERS.reset()
    COUNTERS.synchronize = True
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        COUNTERS.synchronize = False
    counts = COUNTERS.snapshot()
    return out, {"wall_s": time.perf_counter() - t0, "collectives": counts,
                 **collective_totals(counts)}


def uncounted_session(fn, gen: int) -> dict:
    """``fn()``, a ``serve_session`` without ``return_logits``, with no
    synchronize around its collectives (``COUNTERS.synchronize`` off): the
    speed a user sees beside the counted run's.  Its tokens/s, prefill
    and decode seconds, and its collectives' calls and bytes (counted, not
    timed apart) for the session and a generated token."""
    from repro_torch.dist.collectives import COUNTERS

    COUNTERS.reset()
    COUNTERS.synchronize = False
    out = fn()
    totals = collective_totals(COUNTERS.snapshot())
    return {"tokens_per_s": out["tokens_per_s"],
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "collective_calls": totals["collective_calls"],
            "collective_bytes": totals["collective_bytes"],
            "collective_calls_per_token": totals["collective_calls"] / gen,
            "collective_bytes_per_token": totals["collective_bytes"] / gen}


def rank_tp_serve(rank: int, mesh, seed: int, out_dir: str) -> dict:
    """Qwen2.5-3B served over the mesh's model axis through
    ``serve_session`` (launch counters zeroed just before it and read just
    after); then, on the same prompt, one prefill and one decode step
    (rank 0: every B3 and B4 call held against its plain version) and one
    more decode step, its collectives counted.  Rank 0 saves the
    session's logits."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.serve import serve_session

    cfg = configs.get(LM_ARCH)
    scfg = ShardingConfig(data_axes=("data",), model_axes=("model",),
                          kv_shard="heads")
    model, build_s, build_peak, _ = build_timed(cfg, seed)
    whole_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    zero_attention_counters()
    with counted_measurements() as measured:
        out, session = counted_step(lambda: serve_session(
            cfg, batch=TP_BATCH, prompt_len=TP_PROMPT, gen=TP_GEN,
            seed=seed, model=model, scfg=scfg, mesh=mesh,
            return_logits=True))
    launches = attention_launches()
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    uncounted = uncounted_session(lambda: serve_session(
        cfg, batch=TP_BATCH, prompt_len=TP_PROMPT, gen=TP_GEN, seed=seed,
        model=model, scfg=scfg, mesh=mesh), TP_GEN)
    if rank == 0:
        torch.save(out["logits"], Path(out_dir) / "tp_serve_logits.pt")
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TP_BATCH, TP_PROMPT)), device="cuda")
    seen: dict = {}
    tok = torch.as_tensor(out["generated"][:, :2], device="cuda")
    with torch.inference_mode():
        with contextlib.ExitStack() as stack:
            if rank == 0:
                for patch in checked_attention(seen):
                    stack.enter_context(patch)
            _, state = model.prefill(prompt, max_len=TP_PROMPT + TP_GEN)
            model.decode_step(state, tok[:, :1], TP_PROMPT)
        # the next step without the checks, counted
        _, step = counted_step(lambda: model.decode_step(
            state, tok[:, 1:], TP_PROMPT + 1))
        del state
    result = {"build_s": build_s, "build_peak_gib": build_peak,
              "whole_param_bytes": whole_bytes,
              "resident_param_bytes": sum(p.numel() * p.element_size()
                                          for p in model.parameters()),
              "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
              "tokens_per_s": out["tokens_per_s"], "launches": launches,
              "measured": measured["n"], "serve_peak_gib": serve_peak,
              "session": {k: v for k, v in session.items()
                          if k != "collectives"},
              "uncounted": uncounted, "decode_step": step,
              "generated": out["generated"].tolist()}
    if rank == 0:
        result["checked"] = summarize_calls(seen, "tp_serve")
    return result


def phase_tp_serve(ranks: list[dict], kept: list, seed: int) -> dict:
    """Two ranks served Qwen2.5-3B, each on its 8 q heads and 1 kv head
    (``rank_tp_serve``'s results, rank 0's logits ``kept``); now the same
    weights in this process, teacher-forced on the ranks' tokens, against
    the ranks' logits (``seq_serve``'s gate)."""
    import numpy as np

    from repro_torch import configs

    cfg = configs.get(LM_ARCH)
    want = {"flash_attention_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * (TP_GEN - 1),
            "flash_attention_bwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    for r in ranks:
        emit(phase="tp_serve", arch=LM_ARCH, mesh=[1, 2], kv_shard="heads",
             batch=TP_BATCH, prompt_len=TP_PROMPT, gen=TP_GEN,
             heads_a_rank=cfg.n_heads // 2,
             kv_heads_a_rank=max(1, cfg.n_kv_heads // 2),
             **{k: v for k, v in r.items() if k != "generated"},
             first_tokens=r["generated"][0][:8])
        check(r["launches"] == want, f"tp_serve: rank {r['rank']} launches "
                                     f"{r['launches']}, want {want}")
        check(r["measured"] == 0, f"tp_serve: rank {r['rank']} measured "
                                  f"{r['measured']} configurations")
    check(ranks[0]["generated"] == ranks[1]["generated"],
          "tp_serve: the ranks' tokens differ")
    model, _, _, _ = build_timed(cfg, seed)
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TP_BATCH, TP_PROMPT)), device="cuda")
    feed = torch.as_tensor(ranks[0]["generated"], device="cuda")
    whole, _, _ = teacher_forced(model, prompt, feed)
    rel = logit_gap([g.cuda() for g in kept], whole)
    parity = {"steps": len(rel), "rel_err_max": max(rel),
              "prefill_rel_err": rel[0],
              "finite": all(bool(torch.isfinite(g).all()) for g in kept)}
    emit(phase="tp_serve", parity_vs_one_process=parity)
    check(parity["finite"] and parity["rel_err_max"] <= 0.05,
          f"tp_serve: logits vs the one-process run {parity}")
    del model, whole, kept
    torch.cuda.empty_cache()
    return {name: sum(r["launches"][name] for r in ranks) for name in want}


def sharded_cfg():
    """Qwen2-MoE at full width, cut to ``SHARDED_LAYERS`` layers, float32."""
    import dataclasses

    return dataclasses.replace(decoder_cfg(SHARDED_ARCH, SHARDED_LAYERS),
                               compute_dtype="float32")


def sharded_run(seed: int, mesh=None) -> dict:
    """``train_loop`` of ``sharded_cfg`` under the phase's layout (on
    ``mesh``; without one in this process, at the same microbatches and
    remat): losses, step seconds, B3/B5 launches (counters zeroed just
    before, read just after), the collectives' counters, resident
    parameter and moment bytes and peak GiB."""
    import gc

    from repro_torch.dist.collectives import COUNTERS
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.train import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scfg = ShardingConfig(data_axes=("data",), model_axes=("model",),
                          fsdp_axes=("data",), expert_axes=("model",),
                          seq_parallel=True, microbatches=2, remat=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_attention_counters()
    COUNTERS.reset()
    COUNTERS.synchronize = True
    try:
        out = train_loop(sharded_cfg(), steps_total=SHARDED_STEPS,
                         batch=SHARDED_BATCH, seq_len=SHARDED_SEQ, seed=seed,
                         log_every=0, scfg=scfg, mesh=mesh)
    finally:
        COUNTERS.synchronize = False
    counts = COUNTERS.snapshot()
    state = out["state"]
    result = {"losses": out["losses"], "step_seconds": out["step_seconds"],
              "launches": attention_launches(),
              "param_bytes": nbytes(state["params"]),
              "moment_bytes": nbytes(state["opt"]["m"])
              + nbytes(state["opt"]["v"]),
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "collectives_per_step": {
                  k: {f: v[f] / SHARDED_STEPS for f in v}
                  for k, v in counts.items()},
              **{k: v / SHARDED_STEPS for k, v in
                 collective_totals(counts).items()}}
    del out, state
    gc.collect()
    torch.cuda.empty_cache()
    return result


def rank_sharded_train(rank: int, mesh, seed: int) -> dict:
    return sharded_run(seed, mesh)


def sharded_one_process(seed: int) -> dict:
    """``sharded_train``'s run in one process (this one, then freed),
    which its ranks are held to."""
    one = sharded_run(seed)
    emit(phase="sharded_train", ranks=1, arch=SHARDED_ARCH,
         n_layers=SHARDED_LAYERS, batch=SHARDED_BATCH, seq_len=SHARDED_SEQ,
         **one)
    return one


def phase_sharded_train(one: dict, ranks: list[dict]) -> dict:
    """Four ranks on a (2, 2) mesh (``rank_sharded_train``'s results)
    against one process (``sharded_one_process``): losses within
    ``dp_train``'s 2e-4 of it, B3/B5 launches exact a rank (each runs
    every layer on its heads)."""
    for r in ranks:
        emit(phase="sharded_train", ranks=4, mesh=[2, 2], arch=SHARDED_ARCH,
             n_layers=SHARDED_LAYERS, batch=SHARDED_BATCH,
             seq_len=SHARDED_SEQ, **r,
             resident_vs_one_process=(r["param_bytes"] + r["moment_bytes"])
             / (one["param_bytes"] + one["moment_bytes"]))
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                    one["losses"])]
        check(len(rel) == SHARDED_STEPS and max(rel) <= 2e-4,
              f"sharded_train: rank {r['rank']} losses {r['losses']} vs one "
              f"process {one['losses']}")
        check(r["launches"] == one["launches"],
              f"sharded_train: rank {r['rank']} launches {r['launches']}, "
              f"one process {one['launches']}")
    n = SHARDED_LAYERS * 2 * SHARDED_STEPS      # layers x microbatches x steps
    check(one["launches"]["flash_attention_fwd"] == 2 * n
          and one["launches"]["flash_attention_bwd"] == n,
          f"sharded_train: one-process launches {one['launches']}")
    return {name: sum(r["launches"][name] for r in ranks)
            for name in one["launches"]}


# -- A6c: RWKV-6's heads, Mamba's channels and the encoder-decoder over ranks

# RWKV-6 1.6B at full width cut to TPR_RWKV_LAYERS of 24, and Jamba's
# first layer (Mamba, the dense SwiGLU) under mamba_tp, each on a (1, 2)
# mesh: bf16 serving of batch TPR_BATCH (a prompt long enough for B8's
# chunked route, TPR_GEN tokens), then TPR_TRAIN_STEPS float32 training
# steps of TPR_TRAIN_BATCH x TPR_TRAIN_SEQ; Whisper-base at full size
# served on its heads in float32 and in bf16 (batch TPR_BATCH, 1500
# frames, TPR_GEN tokens), then trained on them as the recurrent models
# are (1500 frames, its 448 tokens)
TPR_RWKV_LAYERS, TPR_BATCH, TPR_PROMPT, TPR_GEN = 2, 2, 256, 16
TPR_TRAIN_BATCH, TPR_TRAIN_SEQ, TPR_TRAIN_STEPS = 2, 512, 2
# a leaf's update on the ranks against one process's: the share of its
# entries that differ by more than a quarter of its largest update (an
# Adam step moves an entry by about the learning rate, whatever its
# gradient's size, so a gradient near 0 may take the other sign)
TPR_UPDATE_GATE = 0.01


def scan_fns() -> dict:
    """B6's, B7's, B8's and B9's kernel wrappers, whose ``launches``
    count."""
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk

    return {"wkv6_fwd": wkk.wkv6_fwd, "wkv6_bwd": wkk.wkv6_bwd,
            "selective_scan_fwd": msk.selective_scan_fwd,
            "selective_scan_bwd": msk.selective_scan_bwd}


def zero_tp_counters() -> None:
    zero_attention_counters()
    for fn in scan_fns().values():
        fn.launches = 0
    scan_fns()["wkv6_fwd"].program_launches = {"states": 0, "chunks": 0,
                                               "serial": 0}


def tp_launches() -> dict:
    out = {k: v for k, v in attention_launches().items()
           if not k.startswith("flash_attention_bwd_")}
    out.update({name: fn.launches for name, fn in scan_fns().items()})
    out.update({f"wkv6_fwd_{p_}": n for p_, n in
                scan_fns()["wkv6_fwd"].program_launches.items()})
    return out


def scan_shapes(seen: dict, checked: int):
    """Patches recording every B6-B9 call's operand shape where the ops
    call the kernels (B8, B9: (B, T, H, hd); B6, B7: (B, T, dI)); the
    first ``checked`` calls of each are also held against its plain
    version on the same inputs (``scan_gate``; B7's plain version at the
    kernel's span)."""
    from unittest import mock

    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def wrap(name, fn, plain):
        def call(*args, **launch):
            got = fn(*args, **launch)
            rec = {"shape": list(args[0].shape)}
            if len(seen.get(name, ())) < checked:
                ok, err = scan_gate(got, plain(args, launch))
                rec.update(ok=ok, max_abs_err=err)
            seen.setdefault(name, []).append(rec)
            return got
        return call

    return [mock.patch.object(wkv_ops, "wkv6_fwd", wrap(
                "wkv6_fwd", wkk.wkv6_fwd,
                lambda a, _: wkk.wkv6_fwd_plain(*a[:6]))),
            mock.patch.object(wkv_ops, "wkv6_bwd", wrap(
                "wkv6_bwd", wkk.wkv6_bwd,
                lambda a, _: wkk.wkv6_bwd_plain(*a[:8]))),
            mock.patch.object(ms_ops, "selective_scan_fwd", wrap(
                "selective_scan_fwd", msk.selective_scan_fwd,
                lambda a, _: msk.selective_scan_fwd_plain(*a[:7]))),
            mock.patch.object(ms_ops, "selective_scan_bwd", wrap(
                "selective_scan_bwd", msk.selective_scan_bwd,
                lambda a, kw: msk.selective_scan_bwd_plain(
                    *a[:9], chunk=kw["chunk"])))]


def call_summary(seen: dict) -> dict:
    """Each kernel's recorded calls: how many, their shapes, how many
    were checked, whether all of those passed and the worst gap."""
    return {name: {"calls": len(c),
                   "shapes": sorted({tuple(x["shape"]) for x in c}),
                   "checked": sum("ok" in x for x in c),
                   "ok": all(x.get("ok", True) for x in c),
                   "max_abs_err": max((x.get("max_abs_err", 0.0)
                                       for x in c), default=0.0)}
            for name, c in seen.items()}


def update_gap(got: dict, want: dict, init: dict) -> dict:
    """The ranks' updates (``got`` less ``init``, whole leaves) against
    one process's (``want`` less ``init``): per leaf the share of entries
    that differ by more than a quarter of the leaf's largest update, the
    worst leaf, and the whole model's relative L2 gap."""
    shares, num, den = {}, 0.0, 0.0
    for name, p0 in init.items():
        d_got, d_want = got[name] - p0, want[name] - p0
        gap = (d_got - d_want).abs()
        top = float(d_want.abs().max())
        shares[name] = float((gap > 0.25 * top).float().mean()) if top \
            else float((gap > 0).float().mean())
        num += float(gap.square().sum())
        den += float(d_want.square().sum())
    worst = max(shares, key=shares.get)
    return {"max_share": shares[worst], "worst_leaf": worst,
            "rel_l2": math.sqrt(num / den) if den else 0.0,
            "gate": TPR_UPDATE_GATE}


def tp_train(rank: int, mesh, seed: int, cfg, scfg, seq: int,
             checked: int) -> dict:
    """``train_loop`` of ``cfg`` in float32 (TF32 off) for
    ``TPR_TRAIN_STEPS`` steps on the mesh (counters zeroed just before,
    read just after; rank 0's first ``checked`` calls of each of B6-B9
    held against their plain versions: one step's), its parameters then
    gathered whole; rank 0 runs the same steps in one process from the
    same weights and holds the losses and the update against them."""
    import dataclasses
    import gc

    from repro_torch.dist.collectives import COUNTERS
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tcfg = dataclasses.replace(cfg, compute_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seen: dict = {}
    model = build_model(tcfg, seed=seed)
    zero_tp_counters()
    COUNTERS.reset()
    COUNTERS.synchronize = True
    try:
        with contextlib.ExitStack() as stack:
            for patch in scan_shapes(seen, checked if rank == 0 else 0):
                stack.enter_context(patch)
            run = train_loop(tcfg, steps_total=TPR_TRAIN_STEPS,
                             batch=TPR_TRAIN_BATCH, seq_len=seq, seed=seed,
                             log_every=0, scfg=scfg, mesh=mesh, model=model)
    finally:
        COUNTERS.synchronize = False
    counts = COUNTERS.snapshot()
    state = run["state"]
    out = {"train_launches": tp_launches(), "losses": run["losses"],
           "step_seconds": run["step_seconds"],
           "train_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "train_param_bytes": nbytes(state["params"]),
           "train_moment_bytes": nbytes(state["opt"]["m"])
           + nbytes(state["opt"]["v"]),
           "train_calls": call_summary(seen),
           "train_collectives": {k: {f: v[f] / TPR_TRAIN_STEPS for f in v}
                                 for k, v in counts.items()},
           **{f"train_{k}": v / TPR_TRAIN_STEPS
              for k, v in collective_totals(counts).items()}}
    with torch.no_grad():
        whole = {n: model.layout.unshard(n, p.detach())
                 for n, p in state["params"].items()}
    del run, state, model
    if rank == 0:
        one = build_model(tcfg, seed=seed)
        init = {n: p.detach().clone() for n, p in one.named_parameters()}
        ref = train_loop(tcfg, steps_total=TPR_TRAIN_STEPS,
                         batch=TPR_TRAIN_BATCH, seq_len=seq, seed=seed,
                         log_every=0, model=one)
        out["one_process_losses"] = ref["losses"]
        with torch.no_grad():
            out["update"] = update_gap(whole, ref["state"]["params"], init)
        del one, init, ref
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_recurrent_part(rank: int, mesh, seed: int, cfg, scfg) -> dict:
    """One recurrent model over the mesh's model axis: ``serve_session``
    (bf16; counters zeroed just before, read just after), a prefill and a
    decode step with rank 0's B8/B6 calls held against their plain
    versions, one more decode step's collectives; rank 0 teacher-forces
    the tokens through the whole model in one process.  Then ``tp_train``
    (rank 0's first step's B8/B9 or B6/B7 calls held against their plain
    versions)."""
    from repro_torch.launch.serve import serve_session

    model, build_s, _, _ = build_timed(cfg, seed)
    whole_bytes = nbytes(model.parameters())
    torch.cuda.reset_peak_memory_stats()
    zero_tp_counters()
    with counted_measurements() as measured:
        out, session = counted_step(lambda: serve_session(
            cfg, batch=TPR_BATCH, prompt_len=TPR_PROMPT, gen=TPR_GEN,
            seed=seed, model=model, scfg=scfg, mesh=mesh,
            return_logits=True))
    serve_launches = tp_launches()
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    uncounted = uncounted_session(lambda: serve_session(
        cfg, batch=TPR_BATCH, prompt_len=TPR_PROMPT, gen=TPR_GEN, seed=seed,
        model=model, scfg=scfg, mesh=mesh), TPR_GEN)
    resident = nbytes(model.parameters())
    prompt = seed_prompt(cfg, seed, TPR_BATCH, TPR_PROMPT)
    tok = torch.as_tensor(out["generated"][:, :2], device="cuda")
    seen: dict = {}
    with torch.inference_mode():
        with contextlib.ExitStack() as stack:
            for patch in scan_shapes(seen, 1 << 30 if rank == 0 else 0):
                stack.enter_context(patch)
            _, state = model.prefill(prompt, max_len=TPR_PROMPT + TPR_GEN)
            model.decode_step(state, tok[:, :1], TPR_PROMPT)
        _, step = counted_step(lambda: model.decode_step(
            state, tok[:, 1:], TPR_PROMPT + 1))
        del state
    result = {"build_s": build_s, "whole_param_bytes": whole_bytes,
              "resident_param_bytes": resident,
              "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
              "tokens_per_s": out["tokens_per_s"],
              "serve_launches": serve_launches, "measured": measured["n"],
              "serve_peak_gib": serve_peak,
              "session": {k: v for k, v in session.items()
                          if k != "collectives"},
              "uncounted": uncounted,
              "decode_step": step, "calls": call_summary(seen),
              "generated": out["generated"].tolist()}
    del model
    if rank == 0:
        whole, _, _, _ = build_timed(cfg, seed)
        feed = torch.as_tensor(out["generated"], device="cuda")
        steps, _, _ = teacher_forced(whole, prompt, feed)
        result["parity"] = logit_parity(out["logits"], steps)
        del whole, steps
    del out
    layers = sum(k in ("rwkv", "mamba") for k in cfg.layer_kinds)
    result.update(tp_train(rank, mesh, seed, cfg, scfg, TPR_TRAIN_SEQ,
                           layers))
    return result


def logit_parity(got: list, want: list) -> dict:
    """``seq_serve``'s reading of served logits against one process's."""
    rel = logit_gap([g.cuda() for g in got], want)
    return {"steps": len(rel), "steps_want": len(want),
            "rel_err_max": max(rel), "prefill_rel_err": rel[0],
            "finite": all(bool(torch.isfinite(g).all()) for g in got)}


def whisper_tp_serve(rank: int, mesh, seed: int, cfg, scfg) -> dict:
    """Whisper-base served on the mesh (counters zeroed just before
    ``serve_session``, read just after); rank 0 serves the same weights
    in one process and teacher-forces the ranks' tokens through them."""
    from repro_torch.launch.serve import serve_session

    model, build_s, _, _ = build_timed(cfg, seed)
    whole_bytes = nbytes(model.parameters())
    torch.cuda.reset_peak_memory_stats()
    zero_tp_counters()
    with counted_measurements() as measured:
        served, session = counted_step(lambda: serve_session(
            cfg, batch=TPR_BATCH, prompt_len=WHISPER_FRAMES, gen=TPR_GEN,
            seed=seed, model=model, scfg=scfg, mesh=mesh,
            return_logits=True))
    out = {"build_s": build_s, "whole_param_bytes": whole_bytes,
           "resident_param_bytes": nbytes(model.parameters()),
           "prefill_s": served["prefill_s"],
           "decode_s": served["decode_s"],
           "tokens_per_s": served["tokens_per_s"],
           "serve_launches": tp_launches(), "measured": measured["n"],
           "serve_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "session": session,
           "generated": served["generated"].tolist()}
    out["uncounted"] = uncounted_session(lambda: serve_session(
        cfg, batch=TPR_BATCH, prompt_len=WHISPER_FRAMES, gen=TPR_GEN,
        seed=seed, model=model, scfg=scfg, mesh=mesh), TPR_GEN)
    del model
    if rank == 0:
        whole, _, _, _ = build_timed(cfg, seed)
        one = serve_session(cfg, batch=TPR_BATCH,
                             prompt_len=WHISPER_FRAMES, gen=TPR_GEN,
                             seed=seed, model=whole)
        out["one_process_generated"] = one["generated"].tolist()
        with torch.inference_mode():
            steps = whisper_teacher_forced(
                whole, whisper_frames(cfg, seed, TPR_BATCH, WHISPER_FRAMES),
                torch.as_tensor(served["generated"], device="cuda"))
        out["parity"] = logit_parity(served["logits"], steps)
        del whole, steps
    torch.cuda.empty_cache()
    return out


def rank_tp_recurrent(rank: int, mesh, seed: int) -> dict:
    """RWKV-6 on the model axis, Jamba's first layer under ``mamba_tp``
    (``tp_recurrent_part`` each), then Whisper-base served on its heads in
    float32 and in bf16 (``whisper_tp_serve``) and trained on them
    (``tp_train``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist.sharding import ShardingConfig

    tp = dict(data_axes=("data",), model_axes=("model",), kv_shard="heads")
    out = {"rwkv": tp_recurrent_part(
               rank, mesh, seed, decoder_cfg(RWKV_ARCH, TPR_RWKV_LAYERS),
               ShardingConfig(**tp)),
           "jamba": tp_recurrent_part(
               rank, mesh, seed, decoder_cfg(JAMBA_ARCH, 1),
               ShardingConfig(**tp, mamba_tp=True))}
    cfg = configs.get(WHISPER_ARCH)
    # float32: its tokens against one process are a gate, where bf16 sums
    # of two halves may flip a near-tied argmax; bf16: its logits
    out["whisper"] = whisper_tp_serve(
        rank, mesh, seed, dataclasses.replace(cfg, compute_dtype="float32"),
        ShardingConfig(**tp))
    out["whisper_bf16"] = whisper_tp_serve(rank, mesh, seed, cfg,
                                           ShardingConfig(**tp))
    out["whisper"].update(tp_train(rank, mesh, seed, cfg,
                                   ShardingConfig(**tp), WHISPER_FRAMES, 0))
    return out


def phase_tp_recurrent(ranks: list[dict]) -> dict:
    """Two ranks of a (1, 2) mesh: RWKV-6's heads (B8, B9 on 16 of 32 a
    rank), Jamba's Mamba channels (B6, B7 on 4096 of 8192 a rank) and
    Whisper-base's heads (B3, B4, B5 on 4 of 8).  Tokens equal on both
    ranks; served logits within ``seq_serve``'s 5 % of one process (the
    recurrent models and Whisper in bf16); rank 0's B8 and B6 calls of a
    prefill and a decode step, and its B8/B9 and B6/B7 calls of the first
    training step, within ``scan_parity``'s gates of their plain
    versions; each training step's loss within ``dp_train``'s 2e-4 of one
    process and the update within ``TPR_UPDATE_GATE`` of its; every
    launch count exact on each rank; Whisper's float32 tokens those of
    one process."""
    from repro_torch import configs

    rwkv = decoder_cfg(RWKV_ARCH, TPR_RWKV_LAYERS)
    whisper = configs.get(WHISPER_ARCH)
    heads = rwkv.d_model // rwkv.rwkv.head_dim // 2
    jamba = configs.get(JAMBA_ARCH)
    channels = jamba.mamba.expand * jamba.d_model // 2
    zero = {"flash_attention_fwd": 0, "decode_attention": 0,
            "flash_attention_bwd": 0, "wkv6_fwd": 0, "wkv6_bwd": 0,
            "selective_scan_fwd": 0, "selective_scan_bwd": 0,
            "wkv6_fwd_states": 0, "wkv6_fwd_chunks": 0,
            "wkv6_fwd_serial": 0}
    n, s = TPR_RWKV_LAYERS, TPR_TRAIN_STEPS
    n_attn = whisper.n_encoder_layers + 2 * whisper.n_layers
    whisper_serve = {**zero, "flash_attention_fwd": whisper.n_encoder_layers,
                     "decode_attention": 2 * whisper.n_layers * (TPR_GEN - 1)}
    want = {
        "rwkv": ({**zero, "wkv6_fwd": n * TPR_GEN, "wkv6_fwd_states": n,
                  "wkv6_fwd_chunks": n, "wkv6_fwd_serial": n * (TPR_GEN - 1)},
                 {**zero, "wkv6_fwd": n * s, "wkv6_bwd": n * s,
                  "wkv6_fwd_states": n * s, "wkv6_fwd_chunks": n * s}),
        "jamba": ({**zero, "selective_scan_fwd": 1},
                  {**zero, "selective_scan_fwd": s,
                   "selective_scan_bwd": s}),
        "whisper": (whisper_serve,
                    {**zero, "flash_attention_fwd": n_attn * s,
                     "flash_attention_bwd": n_attn * s}),
        "whisper_bf16": (whisper_serve, None)}
    shapes = {"rwkv": {"wkv6_fwd": heads, "wkv6_bwd": heads},
              "jamba": {"selective_scan_fwd": channels,
                        "selective_scan_bwd": channels},
              "whisper": {}, "whisper_bf16": {}}
    parts = tuple(want)
    layers = {"rwkv": n, "jamba": 1, "whisper": 0}
    for r in ranks:
        for part in parts:
            x = r[part]
            emit(phase="tp_recurrent", part=part, rank=r["rank"], mesh=[1, 2],
                 backend=r["backend"], peak_gib=r["peak_gib"],
                 batch=TPR_BATCH, gen=TPR_GEN,
                 prompt_len=(WHISPER_FRAMES if part.startswith("whisper")
                             else TPR_PROMPT),
                 **({} if part == "whisper_bf16" else
                    {"train_batch": TPR_TRAIN_BATCH,
                     "train_steps": TPR_TRAIN_STEPS,
                     "train_seq": (WHISPER_FRAMES if part == "whisper"
                                   else TPR_TRAIN_SEQ)}),
                 **{k: v for k, v in x.items() if not k.endswith("generated")},
                 first_tokens=x["generated"][0][:8])
            serve_want, train_want = want[part]
            check(x["serve_launches"] == serve_want,
                  f"tp_recurrent {part}: rank {r['rank']} serving launches "
                  f"{x['serve_launches']}, want {serve_want}")
            check(x["measured"] == 0, f"tp_recurrent {part}: measured "
                                      f"{x['measured']} configurations")
            if train_want is not None:
                check(x["train_launches"] == train_want,
                      f"tp_recurrent {part}: rank {r['rank']} training "
                      f"launches {x['train_launches']}, want {train_want}")
            for key in ("calls", "train_calls"):
                for name, width in shapes[part].items():
                    if key == "calls" and name.endswith("bwd"):
                        continue                  # serving runs no backward
                    dims = x[key].get(name, {}).get("shapes")
                    check(dims and all(d[2] == width for d in dims),
                          f"tp_recurrent {part}: {name} shapes {dims}, want "
                          f"{width} a rank")
    r0, r1 = ranks
    for part in parts:
        check(r0[part]["generated"] == r1[part]["generated"],
              f"tp_recurrent {part}: the ranks' tokens differ")
    check(r0["whisper"]["generated"]
          == r0["whisper"]["one_process_generated"],
          "tp_recurrent whisper: tokens differ from one process")
    for part in parts:
        parity = r0[part]["parity"]
        check(parity["finite"] and parity["steps"] == parity["steps_want"]
              and parity["rel_err_max"] <= 0.05,
              f"tp_recurrent {part}: logits vs one process {parity}")
        emit(phase="tp_recurrent", part=part, parity_vs_one_process=parity)
    for part in ("rwkv", "jamba", "whisper"):
        x = r0[part]
        for key in ("calls", "train_calls"):
            calls = x.get(key, {})
            check(all(c["ok"] for c in calls.values()),
                  f"tp_recurrent {part}: rank 0's kernel calls vs their "
                  f"plain versions {calls}")
        for name in shapes[part]:
            got = x["train_calls"][name]["checked"]
            check(got == layers[part],
                  f"tp_recurrent {part}: {got} training calls of {name} "
                  f"checked, want one step's {layers[part]}")
        one = x["one_process_losses"]
        for r in ranks:
            losses = r[part]["losses"]
            check(len(losses) == s == len(one) and all(
                abs(a - b) <= 2e-4 * abs(b) for a, b in zip(losses, one)),
                f"tp_recurrent {part}: rank {r['rank']} losses {losses} vs "
                f"one process {one}")
        update = x["update"]
        check(update["max_share"] <= TPR_UPDATE_GATE,
              f"tp_recurrent {part}: the update vs one process {update}")
        emit(phase="tp_recurrent", part=part, one_process_losses=one,
             update_vs_one_process=update)
    names = ("flash_attention_fwd", "flash_attention_bwd", "decode_attention",
             "wkv6_fwd", "wkv6_bwd", "selective_scan_fwd",
             "selective_scan_bwd")
    return {name: sum(r[part][k][name] for r in ranks for part in parts
                      for k in ("serve_launches", "train_launches")
                      if k in r[part])
            for name in names}


# -- A8: the examples' twins on the card -------------------------------------------
#
# Each twin (``examples/torch_*.py``) is called in-process through its
# ``main(argv)`` (``example_elastic`` in the two-rank spawn), its printed
# lines sent to stderr so standard output stays the JSON lines.  The
# 100M preset trains at the reference's full shape and length (300 steps)
# under deterministic algorithms, and a run resumed from its step-250
# checkpoint must reach the same step-300 parameters bit for bit.

EXAMPLE_RESTART_FROM = 250
EXAMPLE_SERVE_ARGS = ("--batch", "4", "--prompt-len", "32", "--gen", "24")


def example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def release(after: str) -> None:
    """Drop what the script no longer holds and read what stays allocated
    on the card after ``after``."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="release", after=after,
         allocated_gib=torch.cuda.memory_allocated() / 2 ** 30)


def phase_example_dna_real() -> dict:
    """``torch_dna_autotune.real()`` on the card (EM over the 8 chunks,
    then SAM): its B1/B2 counters zeroed just before and read just after;
    every measured count against the plain version's on the card, the
    launches against the measurements (a warm call and a timed one
    each)."""
    from repro_torch.kernels.dna_automaton import kernel, ops

    twin = example("torch_dna_autotune")
    kernel.state_map.launches = 0
    kernel.count_hits.launches = 0
    with contextlib.redirect_stdout(sys.stderr):
        out = twin.real()
    launches = {"dna_state_map": kernel.state_map.launches,
                "dna_count_hits": kernel.count_hits.launches}
    em, sam, measured = out["em"], out["sam"], out["measurements"]
    want = int(ops.fa_match_plain(out["text"], out["table"], out["accept"]))
    emit(phase="example_dna_real", ok=True, symbols=out["text"].numel(),
         motif="ACGTACGT", plain_count=want,
         em_best_ms=em.best_energy_measured * 1e3,
         em_best_chunk=em.best_config["chunk"],
         em_measurements=em.n_experiments,
         sam_best_ms=sam.best_energy_measured * 1e3,
         sam_best_chunk=sam.best_config["chunk"],
         sam_measurements=sam.n_experiments, measured=measured,
         launches=launches)
    check(all(m["count"] == want for m in measured),
          f"example_dna_real: counts {measured}, plain {want}")
    check(em.n_experiments == len(twin.CHUNKS)
          and sam.n_experiments <= em.n_experiments,
          f"example_dna_real: EM {em.n_experiments}, SAM "
          f"{sam.n_experiments} measurements")
    n = 2 * len(measured)
    check(launches == {"dna_state_map": n, "dna_count_hits": n},
          f"example_dna_real: launches {launches}, want {n} each")
    del out
    return launches


def phase_example_serve_lm() -> dict:
    """``torch_serve_lm.main`` (``--smoke`` inserted, batch 4, prompt 32,
    24 tokens) on the card: exact B3/B4 launches, no configuration
    measured."""
    from repro_torch import configs

    twin = example("torch_serve_lm")
    cfg = configs.get(LM_ARCH).smoke()
    zero_attention_counters()
    with counted_measurements() as measured, \
            contextlib.redirect_stdout(sys.stderr):
        out = twin.main(list(EXAMPLE_SERVE_ARGS))
    launches = attention_launches()
    want = {"flash_attention_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * 23,
            "flash_attention_bwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    emit(phase="example_serve_lm", ok=True, arch=cfg.name,
         argv=list(EXAMPLE_SERVE_ARGS), prefill_s=out["prefill_s"],
         decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
         launches=launches, measured=measured["n"],
         first_tokens=out["generated"][0][:8].tolist())
    check(launches == want, f"example_serve_lm: launches {launches}, "
                            f"want {want}")
    check(measured["n"] == 0, f"example_serve_lm: measured {measured['n']}")
    check(tuple(out["generated"].shape) == (4, 24),
          f"example_serve_lm: tokens {out['generated'].shape}")
    return launches


def phase_example_train_100m(seed: int) -> dict:
    """``torch_train_lm.main(["--preset", "100m"])``: 300 steps at batch
    8 x 256, its B3/B5 counters zeroed just before and read just after;
    then the same command on its directory holding only the step-250
    checkpoint, which must resume there and end with the step-300
    parameters bit for bit (both runs under deterministic algorithms);
    then one more step of the final state under the profiler.  The twin
    checkpoints every 250 steps here (its ``CKPT_EVERY``, the reference's
    50 by default): the restart needs the step-250 checkpoint alone, and
    each 1.3 GB checkpoint costs the host-bound step loop ~1 s.  Each
    checkpoint's blocking save (the state copied to the host) and each
    wait for its writer are timed in the run."""
    import shutil
    from unittest import mock

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.steps import train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine

    twin = example("torch_train_lm")
    twin.CKPT_EVERY = EXAMPLE_RESTART_FROM
    preset = twin.PRESETS["100m"]
    cfg = preset["cfg"]()
    steps, batch, seq = preset["steps"], preset["batch"], preset["seq_len"]
    timed: dict = {"save": [], "wait": []}

    def timer(kind, real):
        def wrapped(mgr, *a, **k):
            t0 = time.perf_counter()
            try:
                return real(mgr, *a, **k)
            finally:
                timed[kind].append(time.perf_counter() - t0)
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_100m_") as tmp:
        run_dir = Path(tmp) / "run"
        argv = ["--preset", "100m"]
        torch.use_deterministic_algorithms(True)
        try:
            zero_attention_counters()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr), \
                    mock.patch.object(CheckpointManager, "save", timer(
                        "save", CheckpointManager.save)), \
                    mock.patch.object(CheckpointManager, "wait", timer(
                        "wait", CheckpointManager.wait)):
                out = twin.main([*argv, "--ckpt-dir", str(run_dir)])
            run_s = time.perf_counter() - t0
            launches = attention_launches()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            final = {n: p.detach().clone()
                     for n, p in out["state"]["params"].items()}
            # the step-250 checkpoint alone in the run's directory
            shutil.rmtree(run_dir / f"step_{steps:09d}")
            zero_attention_counters()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                again = twin.main([*argv, "--ckpt-dir", str(run_dir)])
            restart_s = time.perf_counter() - t0
            restart_launches = attention_launches()
        finally:
            torch.use_deterministic_algorithms(False)
        differ = [n for n in final
                  if not torch.equal(again["state"]["params"][n], final[n])]
        resumed_from, resumed_steps = again["resumed_from"], len(
            again["losses"])
        del again
    # a warm step of the final state under the profiler, outside the
    # counted run
    model = build_model(cfg, seed=seed, device="cuda")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(final[n])
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 20, steps))
    split = device_split(lambda: train_step(
        model, out["state"]["opt"], train_batch(cfg, seed, steps, batch, seq),
        opt_cfg, remat=False))
    losses = out["losses"]
    warm = sorted(out["step_seconds"][1:])
    warm_s = warm[len(warm) // 2]
    n = cfg.n_layers
    want = {"flash_attention_fwd": n * steps, "decode_attention": 0,
            "flash_attention_bwd": n * steps,
            "flash_attention_bwd_dq": n * steps,
            "flash_attention_bwd_dkv": n * steps}
    extra = steps - EXAMPLE_RESTART_FROM
    want_restart = {k: v // steps * extra for k, v in want.items()}
    first20, last20 = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    emit(phase="example_train_100m", ok=True, arch=cfg.name,
         params=cfg.param_count(), n_layers=n, batch=batch, seq_len=seq,
         steps=steps, remat=False, ckpt_every=twin.CKPT_EVERY, run_s=run_s,
         steps_s=sum(out["step_seconds"]),
         first_step_s=out["step_seconds"][0],
         losses_every_50={i: losses[i] for i in
                          (*range(0, steps, 50), steps - 1)},
         first20_mean=first20, last20_mean=last20,
         ln_vocab=math.log(cfg.vocab_size), warm_step_s=warm_s,
         tokens_per_s=batch * seq / warm_s, peak_gib=peak_gib,
         checkpoint_save_s=timed["save"], checkpoint_wait_s=timed["wait"],
         launches=launches,
         restart={"resumed_from": resumed_from, "steps": resumed_steps,
                  "seconds": restart_s, "launches": restart_launches,
                  "params_differing": differ, "bit_equal": not differ},
         profiled_step=split)
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"example_train_100m: losses {losses[:5]}...")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"example_train_100m: first loss {losses[0]}, ln V "
          f"{math.log(cfg.vocab_size)}")
    check(last20 < first20, f"example_train_100m: last 20 losses' mean "
                            f"{last20} not below the first 20's {first20}")
    check(launches == want, f"example_train_100m: launches {launches}, "
                            f"want {want}")
    check(resumed_from == EXAMPLE_RESTART_FROM and resumed_steps == extra,
          f"example_train_100m: resumed from {resumed_from}, "
          f"{resumed_steps} steps")
    check(restart_launches == want_restart,
          f"example_train_100m: restart launches {restart_launches}, want "
          f"{want_restart}")
    check(not differ, f"example_train_100m: the run resumed at "
                      f"{EXAMPLE_RESTART_FROM} differs at step {steps}: "
                      f"{differ[:5]}")
    del model, out, final
    return launches


def rank_example_elastic(rank: int, mesh, seed: int) -> dict:
    """``torch_elastic_restart.main`` on the spawn's two ranks (gloo on
    the card; under deterministic algorithms): phase 1 on both, failing at
    step 7 and resumed from 4, then phase 2 on ``make_host_mesh(1)`` (rank
    0 resumes at 12; rank 1 takes no part).  Each ``train_loop`` call of
    the twin has its B3/B5 counters zeroed just before it and read just
    after, and its collectives counted (no synchronize).  Then the same
    training uninterrupted on both ranks to step 16, checkpointed at 12,
    which phase 1 (its step-12 checkpoint) and phase 2 (its losses) are
    held to."""
    import shutil

    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.dist.collectives import COUNTERS

    t_job = time.perf_counter()
    twin = example("torch_elastic_restart")
    calls: list = []
    real = twin.train_loop

    def counted(cfg, **kw):
        zero_attention_counters()
        COUNTERS.reset()
        call = {"steps_total": kw["steps_total"],
                "mesh_size": kw["mesh"].size, "member": kw["mesh"].member}
        try:
            out = real(cfg, **kw)
            call.update(losses=out["losses"], resumed_from=out["resumed_from"],
                        step_seconds=out["step_seconds"])
            return out
        except RuntimeError as e:
            call["failed"] = str(e)
            raise
        finally:
            call.update(launches=attention_launches(),
                        **collective_totals(COUNTERS.snapshot()))
            calls.append(call)

    twin.train_loop = counted
    torch.use_deterministic_algorithms(True)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            out = twin.main([])
        whole_dir = twin.shared_tmpdir()
        whole = real(twin.smoke_cfg(), steps_total=16, ckpt_dir=whole_dir,
                     ckpt_every=12, mesh=mesh,
                     scfg=twin.sharding(mesh.size), device="cuda",
                     **twin.RUN)
    finally:
        torch.use_deterministic_algorithms(False)
        twin.train_loop = real
    result = {"attempts": out["phase1"].attempts,
              "failures": out["phase1"].failures,
              "resumed_from": out["phase1"].result["resumed_from"],
              "phase2_resumed_from": out["phase2"]["resumed_from"],
              "phase2_losses": out["phase2"]["losses"],
              "whole_losses": whole["losses"], "calls": calls}
    if rank == 0:
        got = CheckpointManager(out["ckpt_dir"]).restore(step=12)[1]
        want = CheckpointManager(whole_dir).restore(step=12)[1]
        result["phase1_params_bit_equal"] = all(
            torch.equal(got["params"][n], want["params"][n])
            for n in want["params"])
        result["phase1_params_max_abs_diff"] = max(
            float((got["params"][n] - want["params"][n]).abs().max())
            for n in want["params"])
    dist.barrier()
    if rank == 0:
        shutil.rmtree(out["ckpt_dir"], ignore_errors=True)
        shutil.rmtree(whole_dir, ignore_errors=True)
    result["job_s"] = time.perf_counter() - t_job
    return result


def phase_example_elastic(ranks: list[dict]) -> dict:
    """``rank_example_elastic``'s results: phase 1 restarted once from
    step 4 on both ranks, its step-12 parameters those of the
    uninterrupted run (bit for bit where deterministic, else within
    2e-4); phase 2 resumed at 12 on rank 0 alone, its losses within 2e-4
    of the uninterrupted run's; B3/B5 launches exact a call, rank 1
    launching nothing in phase 2."""
    from repro_torch import configs

    n = configs.get(LM_ARCH).smoke().n_layers

    def want(steps: int) -> dict:
        return {"flash_attention_fwd": n * steps, "decode_attention": 0,
                "flash_attention_bwd": n * steps,
                "flash_attention_bwd_dq": n * steps,
                "flash_attention_bwd_dkv": n * steps}

    for r in ranks:
        per_step = []
        for call in r["calls"]:
            # the failed attempt ran steps 0-6 before its failure at 7
            steps = len(call["losses"]) if "losses" in call else 7
            per_step.append({
                "steps": steps, "mesh_size": call["mesh_size"],
                "member": call["member"],
                "step_s": (sorted(call["step_seconds"])[
                    len(call["step_seconds"]) // 2]
                    if call.get("step_seconds") else None),
                **{f"{k}_per_step": call[k] / steps if steps else 0
                   for k in ("collective_calls", "collective_bytes")}})
        emit(phase="example_elastic", rank=r["rank"], backend=r["backend"],
             peak_gib=r["peak_gib"], per_call=per_step,
             **{k: v for k, v in r.items()
                if k not in ("rank", "backend", "peak_gib")})
        check(r["attempts"] == 2 and r["resumed_from"] == 4,
              f"example_elastic: rank {r['rank']} attempts {r['attempts']}, "
              f"resumed from {r['resumed_from']}")
        first, second, shrunk = r["calls"]
        check(first["launches"] == want(7) and second["launches"] == want(8),
              f"example_elastic: rank {r['rank']} phase 1 launches "
              f"{first['launches']}, {second['launches']}")
        if r["rank"] == 0:
            check(r["phase2_resumed_from"] == 12
                  and shrunk["launches"] == want(4),
                  f"example_elastic: phase 2 resumed from "
                  f"{r['phase2_resumed_from']}, launches {shrunk['launches']}")
            check(len(r["phase2_losses"]) == 4 and all(
                abs(a - b) <= 2e-4 * max(1.0, abs(b)) for a, b in
                zip(r["phase2_losses"], r["whole_losses"][12:])),
                f"example_elastic: phase 2 losses {r['phase2_losses']} vs "
                f"{r['whole_losses'][12:]}")
            check(r["phase1_params_bit_equal"]
                  or r["phase1_params_max_abs_diff"] <= 2e-4,
                  f"example_elastic: phase 1 parameters vs the "
                  f"uninterrupted run: {r['phase1_params_max_abs_diff']}")
        else:
            check(not shrunk["member"] and shrunk["launches"] == want(0)
                  and r["phase2_losses"] == [],
                  f"example_elastic: rank 1 in phase 2 {shrunk}")
    return {name: sum(c["launches"][name] for r in ranks for c in r["calls"])
            for name in want(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=FULL_T,
                    help="symbols of DNA text (default: 3 * 2**30)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="also append every JSON line to DIR/chip_smoke.jsonl")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from repro_torch.kernels.dna_automaton import kernel, ops

    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        EMIT_TO.append(Path(args.out) / "chip_smoke.jsonl")
    smi = phase_env()
    phase_build()
    phase_oracle(args.seed)
    text = ops.random_dna_text(args.t, seed=args.seed, device="cuda")
    records = phase_kernels(text)

    # the DNA path: its launch counters start from 0 just before it
    kernel.state_map.launches = 0
    kernel.count_hits.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        store_path = Path(tmp) / "kernels.json"
        tuned = phase_tune(args.t, args.seed, store_path)
        phase_serve(text, store_path, tuned)
        launches = {"dna_state_map": kernel.state_map.launches,
                    "dna_count_hits": kernel.count_hits.launches}
        # the streamed split (A1): the same text, from pinned host memory,
        # on the same store; its counters start from 0 inside the phase
        stream_launches = phase_stream(text, store_path, args.seed)
    del text
    release("stream")
    # the tune's outcome holds its timer, whose inputs are a text of its
    # own (``KernelTimer.inputs``)
    del tuned
    release("tune_outcome")
    # A8: the DNA example's --real run (EM and SAM over the chunk)
    dna_real_launches = phase_example_dna_real()
    release("example_dna_real")

    # the paper's search (A2): no kernel of ours
    phase_paper_search(args.seed)

    # the LM path, then the same model and store under request traffic (A3)
    attention = phase_attention_parity(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        store_path = Path(tmp) / "kernels.json"
        tunes = phase_lm_tune(args.seed, store_path)
        model, generated, lm_launches = phase_lm_serve(args.seed, store_path,
                                                       tunes)
        phase_lm_parity(model, generated, args.seed)
        request_launches = phase_lm_requests(model, args.seed, store_path,
                                             tunes)
    launches.update(lm_launches)
    # the LM tunes' outcomes hold their timers' inputs (``tunes``)
    del model, tunes
    release("lm_requests")
    # A8: the serving example (the smoke config, as the reference's)
    serve_example_launches = phase_example_serve_lm()
    release("example_serve_lm")

    # the LM-training path
    backward = phase_train_attention_parity(args.seed)
    model, _ = phase_lm_train_parity(args.seed)
    train_launches = phase_lm_train(model, args.seed)
    del model
    release("lm_train")
    # A7: remat="save_dots" at full width, and the dry run against the card
    save_dots = phase_save_dots_train(args.seed)
    release("save_dots_train")
    phase_train_restart(args.seed)
    # A8: the training example's 100M preset, 300 steps, and its restart
    train_100m_launches = phase_example_train_100m(args.seed)
    release("example_train_100m")

    # the other decoders (A4), the VLM and the encoder-decoder (A5): B3, B4
    # and B5 on new paths and shapes
    new_paths = {phase: phase_decoder_serve(phase, arch, n_layers, dtype,
                                            args.seed)
                 for phase, arch, n_layers, dtype in DECODER_PHASES}
    new_paths["whisper_serve"] = phase_whisper_serve(args.seed)
    new_paths["whisper_train"] = phase_whisper_train(args.seed)
    release("whisper_train")

    # the recurrent serving paths, then their training paths on the same
    # store (RWKV-6 trains at the serving shape, where B8 is tuned)
    scans = phase_scan_parity(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as tmp:
        store_path = Path(tmp) / "kernels.json"
        tunes = phase_ssm_tune(args.seed, store_path)
        model, generated, rwkv_launches = phase_ssm_serve(
            RWKV_ARCH, args.seed, store_path, tunes)
        phase_ssm_parity(model, generated, args.seed)
        del model
        release("rwkv_parity")
        model, generated, jamba_launches = phase_ssm_serve(
            JAMBA_ARCH, args.seed, store_path, tunes)
        phase_ssm_parity(model, generated, args.seed)
        del model
        release("jamba_parity")

        bwd_scans = phase_scan_bwd_parity(args.seed)
        tunes.update(phase_ssm_tune(args.seed, store_path, ssm_train_metas(),
                                    phase="ssm_bwd_tune"))
        train_runs = {}
        for arch in (RWKV_ARCH, JAMBA_ARCH):
            model, _ = phase_ssm_train_parity(arch, args.seed)
            train_runs[arch] = phase_ssm_train(model, args.seed, store_path,
                                               tunes)
            del model
            release(f"{arch}_train")
    rwkv_train, jamba_train = train_runs[RWKV_ARCH], train_runs[JAMBA_ARCH]

    # dist/ (A6): ranks sharing the card, spawned after the build.  The
    # one-process runs the ranks are held to come first; then every
    # two-rank path runs in one spawn and the four-rank paths in another,
    # each path's counters zeroed just before it in its ranks and read just
    # after; then each phase's checks on its ranks' results
    seed = args.seed
    dp_one = dp_one_process(seed)
    sharded_one = sharded_one_process(seed)
    release("sharded_one_process")
    data, tp = ((2,), ("data",)), ((1, 2), ("data", "model"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        two = spawn_jobs(2, [
            (rank_seq_decode, *data, ("seq", seed, True)),
            (rank_seq_serve, *data, (seed,)),
            (rank_dp_train, *data, (seed,)),
            # A6b: the heads split over ranks
            (rank_tp_serve, *tp, (seed, tmp)),
            # A6c: the recurrent mixers and the encoder-decoder over ranks
            (rank_tp_recurrent, *tp, (seed,)),
            # A8: the elastic example, phase 2 on a mesh over rank 0
            (rank_example_elastic, *data, (seed,))])
        tp_logits = torch.load(Path(tmp) / "tp_serve_logits.pt")
    four = spawn_jobs(4, [
        (rank_seq_decode, (2, 2), ("data", "model"), ("batch_seq", seed,
                                                      False)),
        # A6b: the heads, experts and parameters split over ranks
        (rank_sharded_train, (2, 2), ("data", "model"), (seed,))])
    phase_seq_decode_parity(two[0], four[0])
    phase_compressed_allreduce(two[0], dp_cfg())
    seq_launches = phase_seq_serve(two[1])
    dp_launches = phase_dp_train(dp_one, two[2])
    tp_launches = phase_tp_serve(two[3], tp_logits, seed)
    sharded_launches = phase_sharded_train(sharded_one, four[1])
    recurrent = phase_tp_recurrent(two[4])
    elastic_launches = phase_example_elastic(two[5])

    records += attention + [backward] + scans + bwd_scans
    by_path = {
        "dna_state_map": {"dna_serve": launches["dna_state_map"],
                          **{path: n["dna_state_map"]
                             for path, n in stream_launches.items()},
                          "example_dna_real":
                              dna_real_launches["dna_state_map"]},
        "dna_count_hits": {"dna_serve": launches["dna_count_hits"],
                           **{path: n["dna_count_hits"]
                              for path, n in stream_launches.items()},
                           "example_dna_real":
                               dna_real_launches["dna_count_hits"]},
        "flash_attention_fwd": {
            "lm_serve": launches["flash_attention_fwd"],
            "lm_requests": request_launches["flash_attention_fwd"],
            "lm_train": train_launches["flash_attention_fwd"],
            "save_dots_train": save_dots["flash_attention_fwd"],
            "jamba_serve": jamba_launches["flash_attention_fwd"],
            "jamba_train": jamba_train["flash_attention_fwd"],
            **{path: n["flash_attention_fwd"]
               for path, n in new_paths.items()},
            "seq_serve": seq_launches["flash_attention_fwd"],
            "dp_train": dp_launches["flash_attention_fwd"],
            "tp_serve": tp_launches["flash_attention_fwd"],
            "sharded_train": sharded_launches["flash_attention_fwd"],
            "tp_recurrent": recurrent["flash_attention_fwd"],
            "example_serve_lm": serve_example_launches["flash_attention_fwd"],
            "example_train_100m":
                train_100m_launches["flash_attention_fwd"],
            "example_elastic": elastic_launches["flash_attention_fwd"]},
        "flash_attention_bwd": {
            "lm_train": train_launches["flash_attention_bwd"],
            "save_dots_train": save_dots["flash_attention_bwd"],
            "jamba_train": jamba_train["flash_attention_bwd"],
            "whisper_train": new_paths["whisper_train"]["flash_attention_bwd"],
            "dp_train": dp_launches["flash_attention_bwd"],
            "sharded_train": sharded_launches["flash_attention_bwd"],
            "tp_recurrent": recurrent["flash_attention_bwd"],
            "example_train_100m":
                train_100m_launches["flash_attention_bwd"],
            "example_elastic": elastic_launches["flash_attention_bwd"]},
        "decode_attention": {
            "lm_serve": launches["decode_attention"],
            "lm_requests": request_launches["decode_attention"],
            "jamba_serve": jamba_launches["decode_attention"],
            **{path: n["decode_attention"] for path, n in new_paths.items()
               if n["decode_attention"]},
            "seq_serve": seq_launches["decode_attention"],
            "tp_serve": tp_launches["decode_attention"],
            "tp_recurrent": recurrent["decode_attention"],
            "example_serve_lm": serve_example_launches["decode_attention"]},
        "wkv6_fwd": {"rwkv_serve": rwkv_launches["wkv6_fwd"],
                     "rwkv_train": rwkv_train["wkv6_fwd"],
                     "tp_recurrent": recurrent["wkv6_fwd"]},
        "wkv6_bwd": {"rwkv_train": rwkv_train["wkv6_bwd"],
                     "tp_recurrent": recurrent["wkv6_bwd"]},
        "selective_scan_fwd": {
            "jamba_serve": jamba_launches["selective_scan_fwd"],
            "jamba_train": jamba_train["selective_scan_fwd"],
            "tp_recurrent": recurrent["selective_scan_fwd"]},
        "selective_scan_bwd": {
            "jamba_train": jamba_train["selective_scan_bwd"],
            "tp_recurrent": recurrent["selective_scan_bwd"]}}
    launches.update({name: sum(paths.values())
                     for name, paths in by_path.items()})
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["name"] in by_path:
            r["launches_by_path"] = by_path[r["name"]]
        check(r["launches"] > 0, f"{r['name']} was never launched on its "
                                 "path")
    torch.cuda.synchronize()

    emit(kernels=records)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
