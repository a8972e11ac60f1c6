#!/usr/bin/env python3
"""Drive aha_tpu_torch's Qwen3 chat, MiniCPM4 chat, embedding / rerank,
LFM2 and Qwen3.5 hybrid chat, Qwen2.5-VL image and video chat, Qwen3-VL
and Qwen3.5 image and video chat, PaddleOCR-VL and DeepSeek-OCR document
OCR, LFM2-VL image chat, Qwen3-ASR / Fun-ASR-Nano speech recognition,
VoxCPM text-to-speech and RMBG-2.0 background removal paths once on one
CUDA card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:

1. device — the card's name, power limit, torch/CUDA/nvcc versions;
2. build — nvcc compiles aha_tpu_torch/csrc/*.cu (set-up time);
3. kernels — each CUDA kernel against its plain PyTorch version at the
   shapes the paths give it (bf16 q, bf16 or int8 caches; the GGUF
   matmuls and MLP also at a verify pass's M = 5 and 9), with error and
   device time per call (profiler) of both; the batched decode also bit
   for bit against one-slot launches; the prefill kernel at Qwen3's 16/8
   heads (S 2048 and 4096) and at Qwen2.5-VL's 16/2 (S 512, 2048), each
   timed beside sdpa; the segment and stacked-decode kernels held relative
   to max |ref| beside a planted fault their bound rejects; decode at
   Qwen2.5-VL-7B's group (28 query heads over 4, G 7), bf16 and int8; the
   one-layer fused decode block, which no path runs, at Qwen3-0.6B's
   widths, alone and as 28 chained launches against the fused stack's
   plain version; the stacked decode at MiniCPM4-0.5B's 8-slot step (L 24,
   S 4096, 16/2, D 64, ragged lengths) and at the hybrids' 8-slot steps
   (6 attention layers: LFM2-1.2B's 32/8 at D 64, Qwen3.5's 16/2 at D
   128), each timed beside masked sdpa, and the prefill kernel at B = 4
   (an embedding group), each slot or row bit-equal to a B = 1 launch;
   the prefill kernel at LFM2-1.2B's 32/8 heads of 64 (S 512, 2048) and
   at Qwen3-VL-8B's 32/8 heads of 128 (S 2048) beside sdpa; the segment
   kernel's D 72 instance at Qwen3-VL-8B's tower (16 heads, strided thirds
   of a fused qkv whose heads differ): (a) a 1024 x 1024 image, one
   segment of 4,096 rows, and (b) an 8-frame 448 x 448 video, 4 frame
   segments of 784 rows and 960 pad rows in the 4,096 bucket, each held
   to TOL_SEG_REL beside two planted faults its bound rejects (a hidden k
   tile; every score taking 8 columns past D from the next head) and timed
   beside masked sdpa (and, for (a), sdpa without a mask);
3b. studies — the H100 design studies (aha_tpu_torch/studies/, the port of
   the TPU studies under scripts/), each through its entry point
   `main(["--quick"])` at the scripts' full geometry: the HBM read ceiling
   (stream_sum), the M = 8 GEMV and the argmax head over the (1024,
   151936) Qwen3 head, the three int4 kernels, and the one-launch layer
   over 28 layers; every kernel held to its plain version and timed beside
   it, its bound and its library yardstick;
4. engine — Qwen3-0.6B's published geometry (28 layers, hidden 1024, vocab
   151936, tied head) with seeded random bf16 weights on the card, through
   TextEngine: plain and kernel prefill, prefix-cache restore, greedy and
   sampled decode through the fused decode stack (≤ 2048 live rows), and
   a 2100-token prompt whose decode runs the per-op chain; the kernels'
   launch counters must all rise; then 8 teacher-forced steps of each
   decode path against the plain path (float32, on the CPU);
4b. spec — prompt-lookup speculative decoding (8 drafts a round, 8 rounds
   a dispatch, each dispatch one graph replay) through TextEngine on the
   same weights: (o) a 300-token prompt of a 48-token cycle, 192 greedy
   tokens, and the same with spec_no_drafts (every a 0, the same stream);
   (p) a 470-token prompt in the 512-row bucket with max_tokens past it,
   drafted and draftless: the host guard drops to single rounds and hands
   the stream to the decode blocks; (q) the int8 cache and (r) the q4
   pack, whose verify pass runs the quantized matmul and MLP kernels at
   M = 9, 96 tokens each.  Each stream equals the plain graphed engine's
   on the same request, or parts from it only where the two candidates'
   f32 logits tie within TOL_SPEC_TIE_REL; each is graphed against eager
   (tokens, accepted counts, launches); ms per emitted token, rounds and
   the accepted counts beside the plain engine's ms per token;
5. batch — the same weights through the continuous-batching BatchEngine
   (8 slots, 12 concurrent requests, one of them sampled, chunked
   admission) over a bf16 and an int8 cache, and an int8 TextEngine; each
   path with the launch counters
   zeroed before it and read after it; then 8 teacher-forced steps of 4
   slots against the f32 plain path on the CPU over the same cache;
6. quant — the same weights packed on the GGUF grids on the card
   (models/qwen3.pack_params, the head too): (j) a q8 and (k) a q4
   TextEngine, whose decode runs the quantized fused stack and whose short
   prompt's prefill runs the quant-matmul and fused-SwiGLU kernels, each
   also timed on the per-op chain; (l) a q4 BatchEngine of 8 slots under
   the (f) request mix; then (m) a Qwen3 GGUF file at full width and 4
   layers, written with the port's writer (token_embd Q8_0 tied, attention
   and gate/up Q4_K, ffn_down Q6_K), loaded with load_qwen3_gguf, 32 greedy
   tokens, and 8 teacher-forced steps through each decode path against the
   same steps on the CPU through the kernels' plain versions (the witness)
   and through the exact dequantized path; each path with the counters
   zeroed before it and its kernels launched;
6b. embed — (t1) Qwen3-Embedding-0.6B on the same weights: 12 texts of
   the test tokenizer over the 32, 128 and 512 buckets, one forward a
   bucket group (the prefill kernel at B = the group's rows, 28 launches a
   group of >= 128 rows), unit vectors within TOL_EMBED_REL of the f32
   plain path on the CPU; (t2) Qwen3-Reranker-0.6B's scores equal to the
   vectors' dot products; (t3) all-MiniLM-L6-v2 at its full geometry in
   f32, 12 texts against the CPU;
7. HTTP — the bf16 weights cut to HTTP_LAYERS (4) layers at full width,
   saved as a checkpoint (embedding rows past the test tokenizer's
   vocabulary zeroed, so replies decode to text) and served by `python -m
   aha_tpu_torch serv` in six child processes started together:
   non-stream, stream and a prefix-cache repeat of /v1/chat/completions;
   a `--spec-tokens 8` server's greedy reply equal to the plain one's;
   then a `--batch-slots 4` server answering 4 chats at once, and the
   same checkpoint served as Qwen/Qwen3-Reranker-0.6B answering /v1/rerank
   with top_n, sorted; each child runs under `-X importtime`, whose log
   must name no module of jax or aha_tpu;
7b. minicpm — (s) MiniCPM4-0.5B's geometry (24 layers, hidden 1024, 16/2
   heads, D 64, vocab 73448, mup scalings, LongRoPE) with seeded bf16
   weights: (s1) a TextEngine, a 300-token prompt and 64 greedy tokens
   (flash_attention 24 a prefill, flash_decode_at_layer 24 a step); (s2)
   a BatchEngine of 8 slots with the prefix store under the (f) mix
   (flash_decode_at_layer 24 a step of 8 slots at per-slot lengths); each
   graphed and eager; 8 teacher-forced steps of 4 slots against the f32
   plain path on the CPU;
7c. http-embed — a MiniLM checkpoint served as
   sentence-transformers/all-MiniLM-L6-v2 (/v1/embeddings of a string and
   an array equal to the in-process vectors, /v1/rerank refused 400) and a
   4-layer MiniCPM4 checkpoint in HF names served as
   OpenBMB/MiniCPM4-0.5B --batch-slots 4 answering 4 chats at once;
7d. hybrid — (u) LFM2-1.2B's published geometry (hidden 2048, ff 8192,
   vocab 65536, tied; 32/8 heads of 64 in its attention layers, gated
   short convs in the rest) cut to its first 8 of 16 layers (2
   attention) and (v) the reference's default Qwen3.5 text config (hidden
   1024, vocab 151936, tied; gated attention at 16/2 heads of 128 every
   4th layer, GatedDeltaNet in the rest) cut to 12 of 24 layers (3
   attention) — HYBRID_DEPTH —, seeded bf16: (u1)/(v1) a TextEngine with
   the prefix store, a 300-token prompt and 64 greedy tokens
   (flash_attention once an attention layer a prefill,
   flash_decode_at_layer once an attention layer a step), graphed and
   eager; its extension restored from the store
   (rows and rolling state) held to a cold engine's stream, and its exact
   repeat, which must match no entry, equal to the cold stream; a decode
   block's idle share; (u2)/(v2) an 8-slot BatchEngine with the prefix
   store under the (f) mix; 8 teacher-forced steps of 4 slots at the
   first 4 layers against the f32 plain path on the CPU; each cut to 4
   layers and served over HTTP under -X importtime, both children started
   together (LFM2 with --batch-slots 4, 4 chats at once; Qwen3.5
   text-only, a non-stream, a stream and a repeat chat); then the plain mixers' device times (the
   delta rule's recurrent step at B 1 and 8, its chunked form at S 512,
   the short conv);
8. vl — (n) Qwen2.5-VL-3B-Instruct's published geometry (vision tower 32
   blocks at hidden 1280, text decoder 36 layers at hidden 2048, vocab
   151936, tied) with seeded bf16 weights on the card, through TextEngine
   with the prefix store: (n1) a 448 x 448 image (1,024 patches, 256 image
   tokens) and (n2) a 980 x 980 one (4,900 patches in the 6,400 bucket,
   1,225 image tokens), 32 greedy tokens each, and (n3) a follow-up turn on
   (n2)'s image that restores its rows and rope_delta from the prefix
   store; the segment-flash, prefill and stacked-decode launch counters
   must rise 32 per image, 36 per prefill of ≥ 128 rows and 36 per decode
   step; then 8 teacher-forced steps at full width and reduced depth (8
   vision blocks, one of them full-attention, 4 text layers) against the
   f32 plain path on the CPU;
8b. vl3 — (w) Qwen3-VL-8B-Instruct's published geometry (tower 27
   blocks at hidden 1152, 16 heads of 72, deepstack after blocks 8, 16
   and 24; text 36 Qwen3 layers at hidden 4096, 32/8 heads of 128, vocab
   151936, untied head, interleaved M-RoPE (24, 20, 20)) with seeded bf16
   weights on the card, through TextEngine with an engine-level prefix
   store: (w1) a 1024 x 1024 image (4,096 patches, 1,024 image tokens),
   (w2) an 8-frame 448 x 448 .npz video at 2 fps through the port's video
   processing (grid (4, 28, 28), 784 video tokens in 4 timestamped
   frames) and (w3) a follow-up turn on (w1)'s image restored from the
   store (rows and rope_delta), 32 greedy tokens each: the segment
   counter 27 per request with vision, the prefill kernel 36 per prefill
   of >= 128 rows, the flat-cache decode 36 and the greedy head 1 per step,
   the fused stack never (decode runs the per-op layers, as the JAX
   model's); then 8 teacher-forced steps at full width and reduced depth
   (4 vision blocks, deepstack after 1, 2, 3; 4 text layers) on a 224 x
   224 image against the f32 plain path on the CPU; (x) the JAX package's
   default Qwen3.5 text config (24 layers, hidden 1024) with its default
   tower (out 1024): a 448 x 448 image chat (27 segment launches, 6
   prefill, 6 decode a step) and the same reduced-depth check; TTFT, the
   tower alone and decode ms/step of each path in one JSON line;
9. vl-http — the reduced-depth models saved as HF-named checkpoints with
   the test tokenizer and the four vision special tokens, each served by
   `python -m aha_tpu_torch serv` in a child process under `-X
   importtime` (no jax or aha_tpu module): Qwen2.5-VL answering a PNG
   data-URL image chat, an .npz data-URL video chat and a text-only chat
   (graphed and --eager, equal replies); Qwen3-VL (config.json model type
   qwen3_vl, served as Qwen/Qwen3-VL-8B-Instruct) an image, a video and a
   text chat; Qwen3.5 with the tower, served as Qwen/Qwen3.5-0.8B, an
   image chat.
10. ocr / lfm2vl — the SigLIP-tower families: (y) PaddleOCR-VL-0.9B's
    published geometry (tower 27 blocks at hidden 1152, 16 heads of 72,
    patch 14; ERNIE-4.5-0.3B 18 layers at hidden 1024, 16/2 heads of 128,
    vocab 103424, tied; contiguous M-RoPE) with seeded bf16 weights through
    TextEngine without a prefix store, as served: (y1) an A4 page at 150
    dpi (1,240 x 1,754 px: 11,088 patches in the 16,384 bucket, one
    segment, 2,772 image tokens, a 4,096-row prompt bucket) under "OCR:",
    (y2) a 448 x 448 and a 672 x 224 image in one request and one segment
    (1,792 patches in the 2,048 bucket, 448 image tokens) under "Table
    Recognition:" and (y3) a 200-token text-only follow-up, 64 greedy
    tokens each: the segment kernel 27 a request with images (D 72 on
    contiguous q/k/v), the prefill kernel 18 a prefill of >= 128 rows,
    flash_decode_at_layer 18 a step, the fused stack never; 8
    teacher-forced steps of (y2) at 4 blocks + 4 layers against the f32
    plain path on the CPU; (z) LFM2-VL-1.6B's geometry (SigLIP2 so400m
    tower, 26 blocks at 1152, 16 heads of 72, patch 16, plain masked sdpa
    as in the reference; projector 2560; LFM2-1.2B's decoder): (z1) an
    unsplit 512 x 512 image (1,024 patches, 256 tokens) and (z2) a 1,536 x
    1,024 one in 3 x 2 tiles of 512 and a 608 x 416 thumbnail (a tower
    batch of 7 in the 1,024 bucket, 1,783 tokens), 64 tokens each, the
    segment kernel never, 6 prefill launches a prefill and 6 decode a
    step; the tower's attention timed beside masked sdpa; teacher-forced
    at 4 + 4 on (z1) and (z2); tower ms, TTFT and decode ms/step graphed
    and eager of each path in one JSON line; the kernel phase also holds the segment
    kernel at (y1)'s page (contiguous q/k/v, S 16,384, plain version in
    chunks of q rows, the two planted faults) beside unmasked sdpa on the
    real rows, the prefill kernel at ERNIE's 16/2 heads (S 4,096) and the
    stacked decode at its 18 layers;
11. siglip-http — each family cut to 4 blocks + 4 layers at full width,
    saved with the test tokenizer and its image tokens (config.json model
    type paddleocr_vl / lfm2-vl) and served by `python -m aha_tpu_torch
    serv` in a child under -X importtime: an image chat and a text chat.
12. dsocr — (aa) DeepSeek-OCR's published geometry (DeepseekOCRConfig():
    SAM ViTDet-B at 1024 px, CLIP-L/14, a DeepSeek-V2 decoder of 12 layers
    at 1280 with 10 heads of 128 over 10, 64 routed experts of 896 top-6
    and 2 shared, layer 0 dense at 6848, vocab 129280; 3.3 B params) with
    seeded bf16 weights through TextEngine without a prefix store, as
    served: (aa1) a 1024 x 1024 image at base = image = 1024 (273 image
    tokens, the 512 bucket) and (aa2) an A4 page at 200 dpi in crop mode
    at base 1024 (6 tiles of 640 and a 1024 view, 903 image tokens, the
    1024 bucket), 64 greedy tokens each: the prefill kernel 12 a prefill
    (G 1), flash_decode_at_layer 12 a step, the towers (float32, as the
    reference's) timed wall and device; the plain MoE layer timed at a
    decode step and at both prefill buckets, with its share of the step;
    8 teacher-forced steps of each at the towers' full depth and 4
    decoder layers against the f32 plain path on the CPU; the kernel
    phase also holds row 1 at 10/10 heads (S 512, 1024) and row 8 at L
    12, S 1024, 300 and 920 live rows beside sdpa;
13. dsocr-http — the model cut to SAM 4 blocks, CLIP 4 layers and 2
    decoder layers at full width, written with HF names and the test
    tokenizer's <image> token, served by `python -m aha_tpu_torch serv
    <dir> --model deepseek-ai/DeepSeek-OCR` in a child under -X
    importtime: a plain image request and a crop_mode one, each reply
    equal to the in-process engine's; then `run` of the id in a child,
    its answer under the family's prompt equal to the in-process one.
14. asr — (ab) Qwen3-ASR-0.6B at bench_asr_rtfx's geometry (encoder 18
    layers at 896, 14 heads of 64, over Qwen3-0.6B) and (ac) Fun-ASR-Nano
    at the JAX package's default one (50 + 20 SANM blocks at 512, 4 heads
    of 128, the adaptor to 1024, Qwen3-0.6B), seeded bf16 weights,
    through their served chat classes on TextEngine without a prefix
    store: (ab1) / (ac1) bench's 30 s seeded waveform (the 3,200-frame
    bucket, S 416, 390 audio tokens; 500 LFR rows in the 512 bucket, 63
    tokens), (ab2) / (ac2) assets/audio/sample.wav ((ab2) in English), 80
    greedy tokens each: the prefill kernel 28 a prefill of >= 128 rows,
    the fused stack and the head once a step, row 10 72 a Fun-ASR request;
    graphed and eager; RTFx (front end + encoder + prefill + 80 tokens,
    best of 2), the encoder wall and device, TTFT; 8 teacher-forced steps
    of (ab1) and (ac1) at full encoder depth and 4 decoder layers against
    the f32 plain path on the CPU; Qwen3-ASR's plain encoder attention
    and Fun-ASR's FSMN memory timed (design candidates); FireRedVAD on
    sample.wav (its probabilities against the CPU's, streaming against
    offline); the kernel phase also holds row 10 at (ac1)'s two shapes;
15. asr-http — Qwen3-ASR cut to 4 encoder and 2 decoder layers at full
    width with HF names and the test tokenizer's audio tokens, served by
    `python -m aha_tpu_torch serv <dir> --model Qwen/Qwen3-ASR-0.6B` in a
    child under -X importtime: a multipart POST of sample.wav to
    /v1/audio/transcriptions (language=en) and an audio chat, each equal
    to the in-process model's reply; then `run` of it and of Fun-ASR-Nano
    cut to 4 + 2 SANM blocks and 2 LLM layers, each equal likewise.
16. tts — (ad) VoxCPM-0.5B at bench.py's geometry (the MiniCPM4-0.5B
    backbone 24 x 1024 / 3072, 16/2 heads of 64, vocab 73448; residual LM
    6 layers; LocEnc 512 x 4; LocDiT 768 x 6; feat 64 x patch 2) and the
    AudioVAE at the reference's defaults, seeded float32 weights as
    served: (ad1) bench's 48-token prompt, 25 patches (min = max), 10 CFM
    steps at cfg 2.0: RTF (80 ms of audio a patch), the first patch, ms a
    patch, one step's device and wall ms, row 8's float32 instance 30
    launches a patch (24 base + 6 residual one-row steps), the VAE decode;
    the first 3 patches' latents against the CPU's from the same weights
    and noise; (ad2) the same on bf16 weights (bench.py's cast, row 8's
    bf16 instance); the kernel phase also holds row 8's float32 instance
    at VoxCPM's two caches (L 24 and 6, S 82, 74 live) and a ragged B 2
    step against its plain version, beside masked sdpa;
17. tts-http — VoxCPM cut to 4 LM + 2 residual layers at full width,
    written as VoxCPM-0.5B's files and served by `python -m aha_tpu_torch
    serv <dir> --model OpenBMB/VoxCPM-0.5B` in a child under -X
    importtime: POST /audio/speech's WAV samples equal to the in-process
    served model's, a streamed request refused, `run --output x.wav`'s
    samples equal to the in-process `synthesize`;
18. rmbg — (ae) RMBG-2.0 at bench.py's Swin-L defaults (embed 192, depths
    2/2/18/2, heads 6/12/24/48, window 12) with the BiRefNet decoder,
    seeded float32 weights: the 1024 px forward's latency (median of 3),
    its device time and that of its Swin window attention and deformable
    convs (the design candidates, plain as in the reference); a 256 px
    matte against the CPU's;
19. rmbg-http — RMBG-2.0 cut to Swin depths 2/2/2/2 at full width, served
    by `python -m aha_tpu_torch serv <dir> --model AI-ModelScope/RMBG-2.0`
    in a child: POST /images/remove_background with two images answers two
    PNGs equal to the in-process served model's, and `run --output`
    writes them.

Every engine path runs its decode blocks as replays of captured CUDA
graphs (core/graphs.py), the engines' default on the card, and once more
through an engine built with cuda_graphs=False (the servers: `serv
--eager`): the greedy tokens, and the sampled ones from the same seed,
must be equal, and so must every kernel's launch count — on the batched
paths, whose scheduler decides by timing how many blocks run, a block's
launches and the launches besides the blocks; each such path prints
`[graphs]` lines (graphs captured, capture seconds, decode ms/step
graphed and eager), gathered in one JSON line before the kernels line.
Every serving path's run must leave the one-layer block's launch count at
0 (no model calls it, as in the JAX package), and the study kernels'
(their path is the studies phase).  Every kernel check also reads the
least time the card could take for the
same work (`bound_ms`: the larger of the bytes it must move over 3.35 TB/s
and its operations over the H100's peak for their type) and, where one
PyTorch call computes the same function, that call's time (`library_ms`;
timed here only, never called by the port).  Then the JSON line of the
graph readings, the JSON line of the speculative paths' readings, the
JSON line of the hybrid readings, the JSON line of the vl3 readings, the
JSON lines of the siglip, the dsocr, the asr, the tts and the rmbg
readings, one JSON line of per-kernel results,
the card line, and
the last line {"ok": true,
"device": {...}}.  Imports nothing of JAX or aha_tpu.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_ATTN = 2e-2          # abs, bf16 kernel vs f32 plain on the same inputs
TOL_HEAD_REL = 1e-3      # a differing index must tie within 1e-3·|max|
TOL_HIDDEN_REL = 5e-2    # bf16 28-layer stack vs f32, relative to max |ref|
TOL_FUSED_REL = 2e-2     # fused stack kernel vs its f32 plain version, same
                         # bf16 inputs, relative to max |ref|
# the quantized stack against its plain version at 28 layers, relative to max
# |ref| (one layer is held to TOL_FUSED_REL).  Its attention output differs
# from the plain one in f32 rounding (exp, split order), and so does the
# 4-bit dot, whose large n·s·sx·Σxq and xsum·b terms cancel: a value that
# lands across a .5 boundary requantizes one step apart and moves every
# column of the next product, and 28 layers of seeded random weights amplify
# that.  Measured on an H100: int8 at pos 0 bit-equal, at pos 1000 2.5e-2;
# with 4-bit grids ≤ 7.9e-2 (≤ 7.3e-3 at one layer); zeroed down scales
# are off by ≥ 0.58
TOL_FUSED_Q8_DEEP_REL = {"q8": 5e-2, "q4": 1.2e-1, "gguf": 1.2e-1}
# q8 decode vs its f32 plain version (the dequantizing fallback), max abs
# error relative to max |ref|, by variant (mxu False: cast, True: all-int8,
# which adds the requantization noise of q and p).  The inputs make the
# outputs O(1) (peaked scores), so a zero or unscaled output is off by ≥ 1.
# Measured on an H100 at these inputs: cast ≤ 2.8e-3 (the bf16 rounding of
# the output), all-int8 ≤ 4.1e-2 (1000 live rows; 1.5e-2 at 16000)
TOL_Q8_REL = {False: 6e-3, True: 8e-2}
# GGUF-grid kernels vs their f32 plain versions on the same bf16 inputs,
# relative to max |ref|: the matmuls round their output to bf16 (≤ 2^-8);
# the fused MLP also requantizes a = SiLU(g)·u, where an f32 rounding can
# move a rare value across a .5 boundary, one step of max|a_g|/127 · |w|
TOL_QMM_REL = 5e-3
TOL_SWIGLU_REL = 1e-2
# (m): the GGUF model's hidden states through the kernels on the card,
# relative to max |ref|, against (a) the witness: the same steps on the CPU
# in bf16 through the kernels' plain versions (the same activation
# quantization), which differs from the card by bf16 rounding and the rare
# activation a summation order moves across a .5 boundary; and (b) the
# exact path: f32 on the CPU with exactly dequantized weights, which
# differs by the activation quantization the kernels do (5.5e-2 and 6.5e-2
# of max |ref| measured over 4 layers on an H100 on the per-op chain)
TOL_GGUF_WITNESS_REL = 1e-1
TOL_GGUF_REL = 1e-1
# (n)'s teacher-forced steps (8 vision blocks, one full-attention, 4 text
# layers at full width): bf16 on the card through the kernels against f32
# on the CPU through the plain versions, max abs error of the hidden states
# relative to max |ref| (the bf16 rounding of every activation through 12
# blocks; the Qwen3 28-layer stack is held to TOL_HIDDEN_REL)
TOL_VL_HIDDEN_REL = 5e-2
# the segment kernel and the stacked-cache decode against their f32 plain
# versions on the same bf16 inputs, max abs error relative to max |ref|.
# The inputs make the outputs O(1) — q drawn 4x wide for the segment
# kernel, so each row's weight sits on a few keys; a planted key per kv
# head at the last live decode row carrying ~0.1-0.9 of every query head's
# weight — so the error is bf16 rounding (≤ 2^-8 of a value, of the output
# and, in the segment kernel, of the probabilities), while a k tile left
# off a block's list or a live length off by one moves some row by most of
# max |ref| (0.7-1.6 in the plain versions; each check plants that fault
# and requires its bound to reject it)
TOL_SEG_REL = 2e-2
TOL_DECODE_REL = 1e-2
# (t): the Qwen3-Embedding vectors (the last row's final hidden, L2-unit)
# through the kernels in bf16 on the card against the f32 plain path on the
# CPU, max abs error relative to max |ref| (the bf16 rounding through 28
# layers, as TOL_HIDDEN_REL holds the chat model's hidden states); all-
# MiniLM-L6-v2 is float32 on both sides (no TF32), max abs error of its
# unit vectors
TOL_EMBED_REL = 5e-2
TOL_MINILM = 1e-4
# 28 chained launches of the one-layer kernel (each layer's rows written by
# the caller) against the fused stack's plain version, relative to max
# |ref|: the layer rounds its residual to bf16 twice per layer where the
# stack carries f32, 56 roundings of ≤ 2^-9 of a value through 28 layers
# of seeded random weights (each layer alone is held to TOL_FUSED_REL)
TOL_CHAIN_REL = 5e-2
# the study kernels (aha_tpu_torch/studies/) against their plain versions,
# each study's main() holding them as it runs: the block sum and the GEMVs
# within 1e-5 of max |ref| (f32 sums in another order; the block sum's total
# of every element within 1e-5 of Σ|w|), the argmax's index equal (or tied
# within 1e-5), the three int4 kernels bit-equal, the one-launch layer
# within 2^-7 of max |ref| (the bf16 roundings of its five folds)
TOL_STUDY = {"stream_sum": 1e-5, "gemv_m8": 1e-5, "gemv_argmax": 1e-5,
             "head_once": 1e-5, "i4_upcast": 0.0, "i4_tensorcore": 0.0,
             "i4_packed_k": 0.0, "fused_layer_stream": 2.0 ** -7}
#: the H100 SXM's published rates (NVIDIA data sheet, dense): HBM bytes/s,
#: operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

KERNELS = {
    "flash_decode_at_layer_flat": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:413"),
    "head_argmax": dict(
        source="aha_tpu_torch/csrc/head_argmax.cu",
        replaces="aha_tpu/ops/lm_head.py:105"),
    "flash_attention": dict(
        source="aha_tpu_torch/csrc/flash_prefill.cu",
        replaces="aha_tpu/ops/flash_attention.py:1264"),
    "fused_decode_stack": dict(
        source="aha_tpu_torch/csrc/fused_decode_stack.cu",
        replaces="aha_tpu/ops/fused_layer.py:396"),
    "flash_decode_at_layer_flat_batched": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:542"),
    "flash_decode_at_layer_q8": dict(
        source="aha_tpu_torch/csrc/decode_attention_q8.cu",
        replaces="aha_tpu/ops/flash_attention.py:775"),
    "flash_decode_at_layer_q8_batched": dict(
        source="aha_tpu_torch/csrc/decode_attention_q8.cu",
        replaces="aha_tpu/ops/flash_attention.py:1013"),
    "quant_matmul": dict(
        source="aha_tpu_torch/csrc/quant_matmul.cu",
        replaces="aha_tpu/ops/quant_matmul.py:262"),
    "quant_matmul_q4": dict(
        source="aha_tpu_torch/csrc/quant_matmul.cu",
        replaces="aha_tpu/ops/quant_matmul.py:341"),
    "quant_swiglu": dict(
        source="aha_tpu_torch/csrc/quant_swiglu.cu",
        replaces="aha_tpu/ops/quant_matmul.py:478"),
    "head_argmax_q8": dict(
        source="aha_tpu_torch/csrc/head_argmax.cu",
        replaces="aha_tpu/ops/lm_head.py:76"),
    "head_argmax_q4": dict(
        source="aha_tpu_torch/csrc/head_argmax.cu",
        replaces="aha_tpu/ops/lm_head.py:87"),
    "fused_decode_stack_q8": dict(
        source="aha_tpu_torch/csrc/fused_decode_stack_q8.cu",
        replaces="aha_tpu/ops/fused_layer.py:728"),
    "flash_attention_segmented": dict(
        source="aha_tpu_torch/csrc/segment_flash.cu",
        replaces="aha_tpu/ops/flash_attention.py:1171"),
    "flash_decode_at_layer": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:235"),
    "flash_decode": dict(
        source="aha_tpu_torch/csrc/decode_attention.cu",
        replaces="aha_tpu/ops/flash_attention.py:166"),
    "fused_decode_layer": dict(
        source="aha_tpu_torch/csrc/fused_decode_layer.cu",
        replaces="aha_tpu/ops/fused_layer.py:856"),
    # the TPU design studies under scripts/, ported as H100 studies
    "stream_sum": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:89"),
    "gemv_m8": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:132"),
    "gemv_argmax": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:188"),
    "head_once": dict(
        source="aha_tpu_torch/csrc/study_gemv.cu",
        replaces="scripts/exp_gemv.py:220"),
    "i4_upcast": dict(
        source="aha_tpu_torch/csrc/study_int4.cu",
        replaces="scripts/exp_int4.py:101"),
    "i4_tensorcore": dict(
        source="aha_tpu_torch/csrc/study_int4.cu",
        replaces="scripts/exp_int4.py:128"),
    "i4_packed_k": dict(
        source="aha_tpu_torch/csrc/study_int4.cu",
        replaces="scripts/exp_int4.py:163"),
    "fused_layer_stream": dict(
        source="aha_tpu_torch/csrc/study_fused_layer.cu",
        replaces="scripts/exp_fused_layer.py:140"),
}
#: the study kernels: their path is the studies' own entry points
STUDY_KERNELS = tuple(TOL_STUDY)
#: kernels no model path runs (as in the JAX package): each serving path's
#: run must leave their counts at 0; the study kernels' main-path count is
#: the studies phase's
OFF_PATH = ("fused_decode_layer",) + STUDY_KERNELS
RESULTS: dict[str, dict] = {k: {"max_abs_err": 0.0, "library_ms": None}
                            for k in KERNELS}


def log(*a):
    print(*a, flush=True)


def require(cond: bool, what) -> None:
    """A check of the run (kept under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(str(what))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time per call: the summed profiler time of the CUDA kernels
    `fn` launches."""
    from aha_tpu_torch.utils.profile_decode import device_ms_per_kernel

    ms = sum(device_ms_per_kernel(fn, iters, warmup).values())
    require(ms > 0, "profiler saw no device time")
    return ms


def wrappers():
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops import lm_head
    from aha_tpu_torch.ops import quant_matmul as qm
    from aha_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                               fused_decode_stack,
                                               fused_decode_stack_q8)
    from aha_tpu_torch.studies import exp_fused_layer, exp_gemv, exp_int4

    return {"flash_decode_at_layer_flat": fa.flash_decode_at_layer_flat,
            "head_argmax": lm_head.head_argmax,
            "flash_attention": fa.flash_attention,
            "fused_decode_stack": fused_decode_stack,
            "flash_decode_at_layer_flat_batched":
                fa.flash_decode_at_layer_flat_batched,
            "flash_decode_at_layer_q8": fa.flash_decode_at_layer_q8,
            "flash_decode_at_layer_q8_batched":
                fa.flash_decode_at_layer_q8_batched,
            "quant_matmul": qm.quant_matmul,
            "quant_matmul_q4": qm.quant_matmul_q4,
            "quant_swiglu": qm.quant_swiglu,
            "head_argmax_q8": lm_head.head_argmax_q8,
            "head_argmax_q4": lm_head.head_argmax_q4,
            "fused_decode_stack_q8": fused_decode_stack_q8,
            "flash_attention_segmented": fa.flash_attention_segmented,
            "flash_decode_at_layer": fa.flash_decode_at_layer,
            "flash_decode": fa.flash_decode,
            "fused_decode_layer": fused_decode_layer,
            "stream_sum": exp_gemv.stream_sum,
            "gemv_m8": exp_gemv.gemv_m8,
            "gemv_argmax": exp_gemv.gemv_argmax,
            "head_once": exp_gemv.head_once,
            "i4_upcast": exp_int4.i4_upcast,
            "i4_tensorcore": exp_int4.i4_tensorcore,
            "i4_packed_k": exp_int4.i4_packed_k,
            "fused_layer_stream": exp_fused_layer.fused_layer_stream}


def zero_counts() -> dict:
    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
    return wr


def read_counts(wr: dict, path: str, must: tuple[str, ...]) -> dict:
    """The counts of one path's run; each kernel in `must` launched, and
    its count recorded as the kernel's main-path launches."""
    launches = {name: fn.launches for name, fn in wr.items()}
    for name in OFF_PATH:
        if name in must:
            continue
        require(launches[name] == 0, f"{name} ran on the {path} path")
        RESULTS[name].setdefault("launches", 0)
        RESULTS[name].setdefault("launches_by_path", {})[path] = 0
    for name in must:
        require(launches[name] > 0,
                f"{name} was not launched on the {path} path")
        RESULTS[name]["launches"] = launches[name]
        RESULTS[name].setdefault("launches_by_path", {})[path] = \
            launches[name]
    log(f"[{path}] launches: {json.dumps(launches)}")
    return launches


#: per path: the graphed engine's graphs and capture seconds, and ms/step
#: graphed and eager (printed as one JSON line before the kernels line)
GRAPH_READINGS: list[dict] = []


def _diff(a: dict, b: dict) -> dict:
    return {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
            if a.get(k) != b.get(k)}


def _graph_stats(eng, device: str) -> dict:
    """The engine's graph count and capture seconds; on the card it must
    hold graphs (the CPU, where the smoke's phases are rehearsed, runs
    eagerly)."""
    require(device != "cuda" or eng.graphs is not None,
            "an engine on the card runs without graphs")
    return (eng.graphs.stats() if eng.graphs is not None
            else {"graphs": 0, "capture_s": 0.0})


def _ms_per_step(timings) -> float:
    """Decode wall ms per step over requests' Timing (the first token is
    the prefill's)."""
    steps = sum(t.completion_tokens - 1 for t in timings)
    return sum(t.completion_secs for t in timings) / max(steps, 1) * 1e3


def eager_twin(path: str, graphed, make_eager, run, outs: list,
               counts: dict, device: str = "cuda",
               groups: dict | None = None) -> None:
    """The path once more through an engine built with cuda_graphs=False:
    `run(engine)` → (token lists, Timings).  Its tokens (greedy, and
    sampled from the same seeds) and every kernel's launch count must
    equal the graphed run's (`outs`, `counts`); then the graphed engine
    repeats `run`, capturing nothing new, for its ms/step with every graph
    already captured.  `groups` names the requests read as one ms/step
    (name → indices; by default all of them, under `path`)."""
    eager = make_eager()
    require(eager.graphs is None, f"[{path}] the eager twin holds graphs")
    wr = zero_counts()
    _sync(device)
    outs_e, t_eager = run(eager)
    _sync(device)
    counts_e = {name: fn.launches for name, fn in wr.items()}
    require(outs_e == outs, f"[{path}] graphed tokens differ from eager: "
            f"{outs} vs {outs_e}")
    require(counts_e == counts, f"[{path}] launches graphed vs eager differ: "
            f"{_diff(counts, counts_e)}")
    stats = _graph_stats(graphed, device)
    _, t_graphed = run(graphed)
    _sync(device)
    require(_graph_stats(graphed, device)["graphs"] == stats["graphs"],
            f"[{path}] a repeat of the same requests captured again")
    card = card_line() if device == "cuda" else "cpu"
    log(f"[graphs] {path}: tokens equal to the eager engine's, every "
        f"kernel's launches equal; {stats['graphs']} graphs captured in "
        f"{stats['capture_s']:.2f} s | {card}")
    for name, idx in (groups or {path: range(len(outs))}).items():
        ms_g = _ms_per_step([t_graphed[i] for i in idx])
        ms_e = _ms_per_step([t_eager[i] for i in idx])
        GRAPH_READINGS.append({"path": name, **stats, "ms_per_step_graphed":
                               ms_g, "ms_per_step_eager": ms_e})
        log(f"[graphs] {name}: decode {ms_g:.3f} ms/step graphed, "
            f"{ms_e:.3f} eager | {card}")


# -- 1. device ----------------------------------------------------------------


def phase_device() -> None:
    require(torch.cuda.get_device_capability(0) == (9, 0),
            f"needs a Hopper card, got {torch.cuda.get_device_capability(0)}")
    from aha_tpu_torch.ops import kernels

    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {card_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{nvcc[-1]}")
    # f32 references below are true f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- 2. build -----------------------------------------------------------------


def phase_build() -> None:
    from aha_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] {kernels.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# -- 3. kernels vs plain ------------------------------------------------------


def bound(nbytes: float, ops: float = 0.0, kind: str = "bf16"
          ) -> tuple[float, str]:
    """The least time (ms) the card could take: the bytes the function
    must move (each input read once, each output written once) over the
    HBM rate, or its operations over the peak for their type, the larger;
    and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name: str, err: float, ms: float | None = None,
            plain_ms: float | None = None,
            bound_of: tuple[float, str] | None = None,
            library_ms: float | None = None, library: str | None = None,
            shape: str | None = None) -> None:
    """Keep the worst error of every check of `name`; a timed check also
    sets its times, its bound (bound_ms, bound_by) and the library call's
    time, all at the shape it names."""
    r = RESULTS[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if ms is not None:
        r["ms"], r["plain_ms"] = ms, plain_ms
        r["bound_ms"], r["bound_by"] = bound_of
        r["library_ms"] = library_ms
        if library is not None:
            r["library"] = library
        r["timed_at"] = shape


def _sdpa(q, k, v, **kw):
    """F.scaled_dot_product_attention on (B, H, S, D) tensors: the
    library yardstick of the attention kernels (the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def check_decode(S: int, valid: int, timed: bool) -> None:
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_flat, flash_decode_at_layer_flat_plain)

    L, Hq, Hkv, D = 28, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(S)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, 1, Hq, D), generator=g, **bf)
    k = torch.randn((L, 1, S, Hkv * D), generator=g, **bf)
    v = torch.randn((L, 1, S, Hkv * D), generator=g, **bf)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    err = 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = flash_decode_at_layer_flat(q, k, v, lt, vl)
        ref = flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                               v.float(), lt, vl)
        torch.cuda.synchronize()
        err = max(err, (got.float() - ref).abs().max().item())
    require(err <= TOL_ATTN,
            f"decode S={S} valid={valid}: err {err}")
    # time across all 28 layers in turn, as one decode step reads them:
    # 28 layers of live rows are far past the 50 MB L2, so each call reads
    # HBM
    layer = _layer_cycle(L)
    ms = device_ms(lambda: flash_decode_at_layer_flat(
        q, k, v, layer(), vl), iters=56)
    plain_ms = device_ms(lambda: flash_decode_at_layer_flat_plain(
        q, k, v, layer(), vl), iters=56)
    nbytes = valid * Hkv * D * 2 * 2                 # bf16 K and V rows
    b = bound(nbytes + 2 * Hq * D * 2, 4 * Hq * valid * D)
    lib_ms = None
    if timed:
        # the library call on the live rows of every layer, laid out
        # (B, H, S, D) beforehand
        kv = [(k[li, :, :valid].reshape(1, valid, Hkv, D).transpose(1, 2)
               .contiguous(), v[li, :, :valid].reshape(1, valid, Hkv, D)
               .transpose(1, 2).contiguous()) for li in range(L)]
        qt = q.transpose(1, 2).contiguous()
        it = iter(range(10 ** 9))
        lib_ms = device_ms(lambda: _sdpa(qt, *kv[next(it) % L]), iters=56)
        del kv
    log(f"[kernels] decode L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}:"
        f" max_abs_err {err:.3e} (tol {TOL_ATTN}); device ms/call kernel"
        f" {ms:.4f} plain {plain_ms:.4f}"
        + (f" sdpa {lib_ms:.4f}" if lib_ms else "")
        + f"; bound {b[0]:.4f} ({b[1]}); {nbytes / ms / 1e6:.1f} GB/s of"
        f" live rows")
    del k, v
    torch.cuda.empty_cache()
    if timed:
        _record("flash_decode_at_layer_flat", err, ms, plain_ms, b, lib_ms,
                "F.scaled_dot_product_attention over the live rows",
                f"L={L} S={S} valid={valid}")
    else:
        _record("flash_decode_at_layer_flat", err)


def check_head(K: int = 1024, key: str | None = None) -> None:
    """The bf16 head kernel over a V 151936 head of width K against its
    plain version: 4 random rows (a differing index must tie within
    TOL_HEAD_REL), a tie planted across vocab tiles, a NaN row; device ms
    of kernel, plain and the torch.matmul GEMV.  K 1024 is the row of the
    JSON line; another K (Qwen3-VL-8B's untied 4096 head) goes under `key`
    in that row."""
    from aha_tpu_torch.ops.lm_head import head_argmax, head_argmax_plain

    V = 151936
    g = torch.Generator(device="cuda").manual_seed(7 if key is None else K)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((V, K), generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    worst, mismatches = 0.0, 0
    for trial in range(4):
        h = torch.randn((1, 1, K), generator=g, **bf)
        got = int(head_argmax({"w": w}, h))
        ref = int(head_argmax_plain(w, h))
        if got != ref:
            logits = h.reshape(1, K).float() @ w.float().t()
            gap = abs(logits[0, got] - logits[0, ref]).item()
            top = logits.abs().max().item()
            require(gap <= TOL_HEAD_REL * top,
                    f"head_argmax K={K} {got} vs plain {ref}: logit gap {gap}")
            worst = max(worst, gap)
            mismatches += 1
    # planted tie across vocab tiles: the smaller index must win
    wt = torch.zeros((V, K), **bf)
    wt[70000, 0] = 1.0
    wt[37, 0] = 1.0
    e0 = torch.zeros((1, K), **bf)
    e0[0, 0] = 1.0
    require(int(head_argmax({"w": wt}, e0)) == 37
            == int(head_argmax_plain(wt, e0)),
            f"K={K}: planted tie did not go to the smaller index")
    del wt
    # a NaN hidden state: the plain fast_argmax rule, index V - 1
    hn = torch.full((1, K), float("nan"), **bf)
    require(int(head_argmax({"w": w}, hn)) == V - 1
            == int(head_argmax_plain(w, hn)),
            f"K={K}: a NaN row did not give V - 1")
    h = torch.randn((1, 1, K), generator=g, **bf)
    ms = device_ms(lambda: head_argmax({"w": w}, h))
    plain_ms = device_ms(lambda: head_argmax_plain(w, h))
    hv = h.reshape(K)
    lib_ms = device_ms(lambda: torch.matmul(w, hv))
    b = bound(V * K * 2 + K * 2, 2 * V * K)
    log(f"[kernels] head_argmax K={K} V={V}: {mismatches} index mismatches "
        f"in 4 random rows (worst logit gap {worst:.3e}), planted tie and NaN "
        f"row agree; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
        f"torch.matmul GEMV alone {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
        f"{V * K * 2 / ms / 1e6:.1f} GB/s of weights")
    del w
    torch.cuda.empty_cache()
    # the kernel returns an index: its "error" is the logit gap between its
    # index and the plain one (0 when they agree)
    if key is not None:
        _record("head_argmax", worst)
        RESULTS["head_argmax"][key] = {
            "max_abs_err": worst, "index_mismatches": mismatches, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "timed_at": f"K={K} V={V}"}
        return
    _record("head_argmax", worst, ms, plain_ms, b, lib_ms,
            "torch.matmul GEMV alone (the logits, no argmax)",
            f"K={K} V={V}")
    RESULTS["head_argmax"].update(
        index_mismatches=mismatches,
        max_abs_err_of="logit gap between kernel and plain argmax")


def check_prefill(S: int, causal: bool, timed: bool, Hkv: int = 8,
                  record: bool = False, Hq: int = 16, D: int = 128) -> None:
    """The prefill kernel against its f32 plain version: Hkv 8 is
    Qwen3-0.6B's 16/8 heads, Hkv 2 Qwen2.5-VL-3B's 16/2 (G = 8), Hq 32
    over Hkv 8 at D 64 LFM2-1.2B's.  Timed: device time of kernel, plain
    and sdpa; `record` makes it the kernel's row of the JSON line, other
    timed shapes go to its `also_timed`."""
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(
        S + causal + Hkv + (Hq - 16) + (D - 128))
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, S, Hq, D), generator=g, **bf)
    k = torch.randn((1, S, Hkv, D), generator=g, **bf)
    v = torch.randn((1, S, Hkv, D), generator=g, **bf)
    got = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    del ref
    require(err <= TOL_ATTN,
            f"prefill S={S} causal={causal} Hkv={Hkv}: err {err}")
    line = (f"[kernels] prefill S={S} causal={causal} Hq={Hq} Hkv={Hkv} "
            f"D={D}: max_abs_err {err:.3e} (tol {TOL_ATTN})")
    _record("flash_attention", err)
    if timed:
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal))
        plain_ms = device_ms(lambda: flash_attention_plain(q, k, v,
                                                           causal=causal),
                             iters=10)
        pairs = S * (S + 1) // 2 if causal else S * S
        b = bound(S * (2 * Hq + 2 * Hkv) * D * 2, 4 * Hq * pairs * D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, is_causal=causal))
        line += (f"; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
                 f"sdpa {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
                 f"{4 * Hq * pairs * D / ms / 1e9:.1f} TFLOP/s")
        shape = f"S={S} causal={causal} Hq={Hq} Hkv={Hkv}" + (
            f" D={D}" if D != 128 else "")
        if record:
            _record("flash_attention", err, ms, plain_ms, b, lib_ms,
                    "F.scaled_dot_product_attention", shape)
        else:
            RESULTS["flash_attention"].setdefault("also_timed", []).append(
                {"at": shape, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b[0], "library_ms": lib_ms})
    log(line)


def _q8_cache(g, L: int, B: int, S: int):
    """Seeded int8 K/V rows and f32 scales at Qwen3-0.6B's widths.  q is
    drawn 4× wider than N(0, 1), so scores spread over ~2 nats and a few
    dozen rows carry most of the weight: outputs of O(1), not the ~1e-2 of
    a flat average over thousands of random rows."""
    Hq, Hkv, D = 16, 8, 128
    i8 = dict(generator=g, device="cuda", dtype=torch.int8)
    q = (torch.randn((B, 1, Hq, D), generator=g, device="cuda") * 4).to(
        torch.bfloat16)
    k = torch.randint(-127, 128, (L, B, S, Hkv * D), **i8)
    v = torch.randint(-127, 128, (L, B, S, Hkv * D), **i8)
    ks = torch.rand((L, B, S, Hkv), generator=g, device="cuda") * 0.01 + 2e-3
    vs = torch.rand((L, B, S, Hkv), generator=g, device="cuda") * 0.01 + 2e-3
    return q, k, v, ks, vs


def _q8_err(got: torch.Tensor, ref: torch.Tensor, mxu: bool, what: str,
            rel: dict) -> float:
    """Holds `got` to TOL_Q8_REL[mxu]; keeps the worst relative error per
    variant in `rel`; returns the max abs error."""
    r = _rel(got, ref)
    require(r <= TOL_Q8_REL[mxu],
            f"{what} mxu={mxu}: err {r} of max |ref| (tol {TOL_Q8_REL[mxu]})")
    rel[mxu] = max(rel.get(mxu, 0.0), r)
    return (got.float() - ref).abs().max().item()


def _layer_cycle(L: int):
    layers = [torch.tensor(i, dtype=torch.int32, device="cuda")
              for i in range(L)]
    it = iter(range(10 ** 9))
    return lambda: layers[next(it) % L]


def check_q8(S: int, valid: int, timed: bool) -> None:
    """Both q8 variants at B = 1 against the plain version, a repeat
    bit-equal; device time of each over the 28 layers in turn, its bound,
    and the bytes/s of the live rows."""
    from aha_tpu_torch.ops.flash_attention import (
        flash_decode_at_layer_q8, flash_decode_at_layer_q8_plain)

    L, Hkv, D = 28, 8, 128
    g = torch.Generator(device="cuda").manual_seed(S + 1)
    q, k, v, ks, vs = _q8_cache(g, L, 1, S)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    layer = _layer_cycle(L)
    err, ms, rel = 0.0, {}, {}
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, lt, vl)
        for mxu in (False, True):
            got = flash_decode_at_layer_q8(q, k, v, ks, vs, lt, vl, mxu=mxu)
            again = flash_decode_at_layer_q8(q, k, v, ks, vs, lt, vl,
                                             mxu=mxu)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"q8 S={S} valid={valid} mxu={mxu}: a repeat differs")
            err = max(err, _q8_err(got, ref, mxu, f"q8 S={S} valid={valid}",
                                   rel))
    # the bound tells a wrong output from a right one: zeros, and the
    # output of a kernel that forgot the v scales, both fail it
    unscaled = flash_decode_at_layer_q8_plain(
        q.float(), k, v, ks, torch.ones_like(vs), lt, vl)
    bad = {"zeros": _rel(torch.zeros_like(ref), ref),
           "v unscaled": _rel(unscaled, ref)}
    require(min(bad.values()) > max(TOL_Q8_REL.values()),
            f"q8 bound does not reject a wrong output: {bad}")
    for mxu in (False, True):
        ms[mxu] = device_ms(lambda: flash_decode_at_layer_q8(
            q, k, v, ks, vs, layer(), vl, mxu=mxu), iters=56)
    plain_ms = device_ms(lambda: flash_decode_at_layer_q8_plain(
        q, k, v, ks, vs, layer(), vl), iters=28)
    nbytes = valid * Hkv * (D + 4) * 2          # int8 rows + f32 scales
    b = bound(nbytes + 2 * 16 * D * 2, 4 * 16 * valid * D)
    log(f"[kernels] q8 decode L={L} S={S} valid={valid} Hq=16 Hkv={Hkv} "
        f"D={D}: err of max |ref| cast {rel[False]:.3e} int8 "
        f"{rel[True]:.3e} (tol {TOL_Q8_REL[False]}/{TOL_Q8_REL[True]}; "
        f"zeros {bad['zeros']:.3g}, v unscaled {bad['v unscaled']:.3g}), "
        f"max_abs_err {err:.3e}, a repeat bit-equal; device ms/call cast "
        f"{ms[False]:.4f} int8 {ms[True]:.4f} plain {plain_ms:.4f}; bound "
        f"{b[0]:.4f} ({b[1]}); {nbytes / ms[True] / 1e6:.1f} GB/s (int8) of "
        f"live rows")
    if timed:
        _record("flash_decode_at_layer_q8", err, ms[True], plain_ms, b, None,
                None, f"L={L} S={S} valid={valid} all-int8")
        RESULTS["flash_decode_at_layer_q8"]["ms_cast_variant"] = ms[False]
    else:
        _record("flash_decode_at_layer_q8", err)
    del k, v, ks, vs
    torch.cuda.empty_cache()


def check_batched(timed: bool) -> None:
    """The batched bf16 and q8 decode at the BatchEngine's shapes: 8 slots
    of a 4096-row cache, ragged lengths (a parked slot of 1, the split
    boundaries 64 and 128, the full 4096); bf16 bit-equal to eight B = 1
    launches; errors and device times against the plain versions."""
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.utils.profile_decode import RAGGED

    L, B, S, Hkv, D = 28, 8, 4096, 8, 128
    g = torch.Generator(device="cuda").manual_seed(8)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, 1, 16, D), generator=g, **bf)
    k = torch.randn((L, B, S, Hkv * D), generator=g, **bf)
    v = torch.randn((L, B, S, Hkv * D), generator=g, **bf)
    vl = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    layer = _layer_cycle(L)
    err = 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fa.flash_decode_at_layer_flat_batched(q, k, v, lt, vl)
        ref = fa.flash_decode_at_layer_flat_plain(q.float(), k.float(),
                                                  v.float(), lt, vl)
        err = max(err, (got.float() - ref).abs().max().item())
        for b in range(B):
            one = fa.flash_decode_at_layer_flat(
                q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                v[:, b:b + 1].contiguous(), lt, vl[b:b + 1].contiguous())
            require(torch.equal(one, got[b:b + 1]),
                    f"batched decode slot {b} differs from a B = 1 launch")
    require(err <= TOL_ATTN, f"batched decode err {err}")
    ms = device_ms(lambda: fa.flash_decode_at_layer_flat_batched(
        q, k, v, layer(), vl), iters=56)
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_flat_plain(
        q, k, v, layer(), vl), iters=28)
    live = sum(RAGGED)
    b = bound(live * Hkv * D * 2 * 2 + 2 * B * 16 * D * 2,
              4 * 16 * live * D)
    # the library call: one masked attention over each slot's whole cache
    mask = (torch.arange(S, device="cuda")[None, :]
            < vl[:, None]).reshape(B, 1, 1, S)
    qt = q.transpose(1, 2).contiguous()
    kv = [(k[li].reshape(B, S, Hkv, D).transpose(1, 2).contiguous(),
           v[li].reshape(B, S, Hkv, D).transpose(1, 2).contiguous())
          for li in range(L)]
    it = iter(range(10 ** 9))
    lib_ms = device_ms(lambda: _sdpa(qt, *kv[next(it) % L], attn_mask=mask),
                       iters=56)
    del kv
    log(f"[kernels] batched decode L={L} B={B} S={S} lengths {RAGGED}: "
        f"max_abs_err {err:.3e} (tol {TOL_ATTN}), each slot bit-equal to a "
        f"B = 1 launch; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
        f"masked sdpa {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
    if timed:
        _record("flash_decode_at_layer_flat_batched", err, ms, plain_ms, b,
                lib_ms, "F.scaled_dot_product_attention, a per-slot length "
                "mask over the whole cache", f"L={L} B={B} S={S} ragged")
    else:
        _record("flash_decode_at_layer_flat_batched", err)
    del k, v
    torch.cuda.empty_cache()

    q, k, v, ks, vs = _q8_cache(g, L, B, S)
    err, rel = 0.0, {}
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = fa.flash_decode_at_layer_q8_plain(q.float(), k, v, ks, vs, lt,
                                                vl)
        for mxu in (False, True):
            got = fa.flash_decode_at_layer_q8_batched(q, k, v, ks, vs, lt, vl,
                                                      mxu=mxu)
            again = fa.flash_decode_at_layer_q8_batched(q, k, v, ks, vs, lt,
                                                        vl, mxu=mxu)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"q8 batched mxu={mxu}: a repeat differs")
            err = max(err, _q8_err(got, ref, mxu, "q8 batched", rel))
            for b in range(B):
                one = fa.flash_decode_at_layer_q8(
                    q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                    v[:, b:b + 1].contiguous(), ks[:, b:b + 1].contiguous(),
                    vs[:, b:b + 1].contiguous(), lt,
                    vl[b:b + 1].contiguous(), mxu=mxu)
                require(torch.equal(one, got[b:b + 1]),
                        f"q8 batched mxu={mxu}: slot {b} differs from a "
                        "B = 1 launch")
    ms = {mxu: device_ms(lambda: fa.flash_decode_at_layer_q8_batched(
        q, k, v, ks, vs, layer(), vl, mxu=mxu), iters=56)
        for mxu in (False, True)}
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_q8_plain(
        q, k, v, ks, vs, layer(), vl), iters=28)
    b8 = bound(live * Hkv * (D + 4) * 2 + 2 * B * 16 * D * 2,
               4 * 16 * live * D)
    log(f"[kernels] q8 batched decode L={L} B={B} S={S} lengths {RAGGED}: "
        f"err of max |ref| cast {rel[False]:.3e} int8 {rel[True]:.3e} (tol "
        f"{TOL_Q8_REL[False]}/{TOL_Q8_REL[True]}), max_abs_err {err:.3e}, "
        f"each slot bit-equal to a B = 1 launch and to a repeat; "
        f"device ms/call cast {ms[False]:.4f} "
        f"int8 {ms[True]:.4f} plain {plain_ms:.4f}; bound {b8[0]:.4f} "
        f"({b8[1]})")
    if timed:
        _record("flash_decode_at_layer_q8_batched", err, ms[True], plain_ms,
                b8, None, None,
                f"L={L} B={B} S={S} ragged all-int8")
    else:
        _record("flash_decode_at_layer_q8_batched", err)
    if timed:
        RESULTS["flash_decode_at_layer_q8_batched"]["ms_cast_variant"] = \
            ms[False]
    del k, v, ks, vs
    torch.cuda.empty_cache()


#: Qwen3-0.6B's fused decode projections (in, out): q|k|v, o, gate|up, down
PROJECTIONS = {"qkv": (1024, 4096), "o": (2048, 1024),
               "gateup": (1024, 6144), "down": (3072, 1024)}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _pack(g, n: int, k: int, grid: str, scale: float = 0.02) -> dict:
    from aha_tpu_torch.ops.quant_matmul import pack_rows

    w = torch.randn((n, k), generator=g, device="cuda") * scale
    if grid == "q4":
        w += 0.25 * scale        # the 4-bit grid's min term matters
    return pack_rows(w, grid == "q4")


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def check_quant_matmul(grid: str) -> None:
    """The int8 or 4-bit matmul at the four projections of Qwen3-0.6B (M =
    1, 5, 8, 9, 64) and the head logits of BatchEngine's step (M = 8) and
    of a speculative verify pass at 4 and 8 drafts (M = 5, 9; N = 151936),
    each against the f32 plain version on the same bf16 inputs within
    TOL_QMM_REL of max |ref|; zeroed scales (q8) or a dropped xsum·b term
    (q4) fail that bound; a repeat bit-equal, and each row of an M = 5, 8
    or 9 launch bit-equal to an M = 1 launch of that row alone.  Device
    time of kernel and plain at M = 1, 5, 8 and 9 of each projection and
    of the head; `quant_matmul[_q4]_timings` keeps them all."""
    from aha_tpu_torch.ops import quant_matmul as qm

    name = "quant_matmul_q4" if grid == "q4" else "quant_matmul"
    fn = getattr(qm, name)
    plain = getattr(qm, name + "_plain")
    keys = qm.GRID_KEYS[grid]
    g = torch.Generator(device="cuda").manual_seed(21 + len(grid))
    shapes = [(proj, k, n, m) for proj, (k, n) in PROJECTIONS.items()
              for m in (1, 5, 8, 9, 64)] + [("head", 1024, 151936, m)
                                            for m in (5, 8, 9)]
    worst, worst_bad = 0.0, float("inf")
    timings = RESULTS[name].setdefault("timings", {})
    for proj, K, N, M in shapes:
        p = _pack(g, N, K, grid)
        args = [p[k] for k in keys]
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        got = fn(x, *args)
        again = fn(x, *args)
        ref = plain(x.float(), *args)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"{name} {proj} M={M}: a repeat "
                f"is not bit-equal")
        if M in (5, 8, 9):
            for r in range(M):
                require(torch.equal(got[r], fn(x[r:r + 1], *args)[0]),
                        f"{name} {proj}: row {r} of M={M} differs from "
                        f"M=1")
        err = _rel(got, ref)
        require(err <= TOL_QMM_REL, f"{name} {proj} M={M}: err {err} of "
                f"max |ref| (tol {TOL_QMM_REL})")
        worst = max(worst, err)
        _record(name, (got.float() - ref).abs().max().item())
        if grid == "q8":
            bad = plain(x.float(), args[0], torch.zeros_like(args[1]))
        else:
            bad = plain(x.float(), *args[:2], torch.zeros_like(args[2]))
        worst_bad = min(worst_bad, _rel(bad, ref))
        if M in (1, 5, 8, 9):
            wbytes = _nbytes(p)
            ms = device_ms(lambda: fn(x, *args))
            plain_ms = device_ms(lambda: plain(x, *args), iters=5)
            b = bound(wbytes + M * K * 2 + M * N * 2, 2 * M * N * K, "int8")
            log(f"[kernels] {name} {proj} M={M} K={K} N={N}: err {err:.3e} "
                f"of max |ref|; device ms/call kernel {ms:.4f} plain "
                f"{plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
                f"{wbytes / ms / 1e6:.1f} GB/s of weights")
            timings[f"{proj} M={M}"] = {"ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": b[0]}
            if proj == "qkv" and M == 1:
                _record(name, 0.0, ms, plain_ms, b, None, None,
                        f"q|k|v M=1 K={K} N={N}")
        del p, args
    require(worst_bad > TOL_QMM_REL, f"{name}: the bound does not reject "
            f"{'zeroed scales' if grid == 'q8' else 'a dropped xsum*b'}")
    log(f"[kernels] {name}: {len(shapes)} shapes within {worst:.3e} of max "
        f"|ref| (tol {TOL_QMM_REL}), repeats and M=5/8/9 rows against M=1 "
        f"bit-equal; "
        f"{'zeroed scales' if grid == 'q8' else 'dropped xsum*b term'} off "
        f"by ≥ {worst_bad:.3g}")
    torch.cuda.empty_cache()


def check_quant_swiglu() -> None:
    """The fused quantized MLP at Qwen3-0.6B's widths (H 1024, I 3072) in
    all four grid pairs at M = 1, 5, 8 and 9 (5 and 9: a speculative
    verify pass), against the f32 plain version within TOL_SWIGLU_REL of
    max |ref|; zeroed down scales fail the bound; a repeat bit-equal, and
    each row of M > 1 bit-equal to M = 1 of that row alone.  Device time
    at M = 1 of each pair and at M = 5, 8 and 9 of q8/q8 and q4/q4
    (`quant_swiglu_timings`)."""
    from aha_tpu_torch.ops import quant_matmul as qm

    H, I = 1024, 3072
    g = torch.Generator(device="cuda").manual_seed(31)
    worst, worst_bad = 0.0, float("inf")
    timings = RESULTS["quant_swiglu"].setdefault("timings", {})
    for gu_fmt in ("q8", "q4"):
        for dn_fmt in ("q8", "q4"):
            gu = _pack(g, 2 * I, H, gu_fmt)
            dn = _pack(g, H, I, dn_fmt)
            for M in (1, 5, 8, 9):
                x = torch.randn((1, M, H), generator=g, device="cuda").to(
                    torch.bfloat16)
                got = qm.quant_swiglu(gu, dn, x)
                again = qm.quant_swiglu(gu, dn, x)
                ref = qm.quant_swiglu_plain(gu, dn, x.reshape(M, H).float())
                torch.cuda.synchronize()
                require(torch.equal(got, again), f"quant_swiglu {gu_fmt}/"
                        f"{dn_fmt} M={M}: a repeat is not bit-equal")
                for r in range(M if M > 1 else 0):
                    one = qm.quant_swiglu(gu, dn, x[:, r:r + 1].contiguous())
                    require(torch.equal(got[0, r], one[0, 0]),
                            f"quant_swiglu {gu_fmt}/{dn_fmt}: row {r} of "
                            f"M={M} differs from M=1")
                err = _rel(got.reshape(M, H), ref)
                require(err <= TOL_SWIGLU_REL, f"quant_swiglu {gu_fmt}/"
                        f"{dn_fmt} M={M}: err {err} (tol {TOL_SWIGLU_REL})")
                worst = max(worst, err)
                _record("quant_swiglu", (got.reshape(M, H).float() - ref)
                        .abs().max().item())
                zeroed = {k: torch.zeros_like(v) if k in ("st", "s4") else v
                          for k, v in dn.items()}
                worst_bad = min(worst_bad, _rel(qm.quant_swiglu_plain(
                    gu, zeroed, x.reshape(M, H).float()), ref))
            for M in ((1, 5, 8, 9) if gu_fmt == dn_fmt else (1,)):
                x = torch.randn((1, M, H), generator=g, device="cuda").to(
                    torch.bfloat16)
                ms = device_ms(lambda: qm.quant_swiglu(gu, dn, x))
                plain_ms = device_ms(lambda: qm.quant_swiglu_plain(
                    gu, dn, x.reshape(M, H)), iters=5)
                wbytes = _nbytes(gu) + _nbytes(dn)
                b = bound(wbytes + 2 * M * H * 2,
                          2 * M * (2 * I * H + H * I), "int8")
                log(f"[kernels] quant_swiglu {gu_fmt}/{dn_fmt} M={M} H={H} "
                    f"I={I}: device ms/call kernel {ms:.4f} plain "
                    f"{plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
                    f"{wbytes / ms / 1e6:.1f} GB/s of weights")
                timings[f"{gu_fmt}/{dn_fmt} M={M}"] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0]}
                if gu_fmt == dn_fmt == "q8" and M == 1:
                    _record("quant_swiglu", 0.0, ms, plain_ms, b, None, None,
                            f"q8/q8 M=1 H={H} I={I}")
    require(worst_bad > TOL_SWIGLU_REL,
            "quant_swiglu: the bound does not reject zeroed down scales")
    log(f"[kernels] quant_swiglu: 4 grid pairs x M in (1, 5, 8, 9) within "
        f"{worst:.3e} of max |ref| (tol {TOL_SWIGLU_REL}), repeats and M>1 "
        f"rows against M=1 bit-equal; zeroed down "
        f"scales off by ≥ {worst_bad:.3g}")
    torch.cuda.empty_cache()


def check_quant_heads() -> None:
    """The int8 and 4-bit greedy heads at Qwen3-0.6B's vocabulary: each
    random row's index equal to the plain version's or tied with it within
    TOL_HEAD_REL of max |logit|; a tie planted across blocks goes to the
    smaller index; a NaN row gives V − 1; zeroed scales change the index."""
    from aha_tpu_torch.ops import lm_head
    from aha_tpu_torch.ops.quant_matmul import pack_rows, qdot, quant_acts

    K, V = 1024, 151936
    g = torch.Generator(device="cuda").manual_seed(41)
    for grid in ("q8", "q4"):
        name = f"head_argmax_{grid}"
        p = _pack(g, V, K, grid)
        worst, mismatches, moved = 0.0, 0, 0
        for _ in range(4):
            h = torch.randn((1, 1, K), generator=g, device="cuda").to(
                torch.bfloat16)
            got = int(lm_head.head_argmax(p, h))
            ref = int(lm_head.quant_head_plain(p, h))
            if got != ref:
                logits = qdot(p, *quant_acts(h.reshape(1, K).float(), K))[0]
                gap = abs(logits[got] - logits[ref]).item()
                require(gap <= TOL_HEAD_REL * logits.abs().max().item(),
                        f"{name} {got} vs plain {ref}: logit gap {gap}")
                worst = max(worst, gap)
                mismatches += 1
            zeroed = {k: torch.zeros_like(v) if k in ("st", "s4", "b4") else v
                      for k, v in p.items()}
            moved += int(lm_head.quant_head_plain(zeroed, h)) != ref
        require(moved > 0, f"{name}: zeroed scales kept every index")
        wt = torch.zeros((V, K), device="cuda")
        wt[70000, :4] = wt[37, :4] = 1.0
        wt[5000, :4] = 0.5
        e0 = torch.zeros((1, K), dtype=torch.bfloat16, device="cuda")
        e0[0, :4] = 1.0
        pt = pack_rows(wt, grid == "q4")
        require(int(lm_head.head_argmax(pt, e0)) == 37
                == int(lm_head.quant_head_plain(pt, e0)),
                f"{name}: planted tie did not go to the smaller index")
        hn = torch.full((1, K), float("nan"), dtype=torch.bfloat16,
                        device="cuda")
        require(int(lm_head.head_argmax(p, hn)) == V - 1
                == int(lm_head.quant_head_plain(p, hn)),
                f"{name}: a NaN row did not give V - 1")
        h = torch.randn((1, 1, K), generator=g, device="cuda").to(
            torch.bfloat16)
        ms = device_ms(lambda: lm_head.head_argmax(p, h))
        plain_ms = device_ms(lambda: lm_head.quant_head_plain(p, h), iters=5)
        wbytes = _nbytes(p)
        b = bound(wbytes + K * 2, 2 * V * K, "int8")
        log(f"[kernels] {name} K={K} V={V}: {mismatches} index mismatches in "
            f"4 random rows (worst logit gap {worst:.3e}), zeroed scales moved "
            f"{moved}/4, planted tie and NaN row agree; device ms/call kernel "
            f"{ms:.4f} plain {plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
            f"{wbytes / ms / 1e6:.1f} GB/s of weights")
        _record(name, worst, ms, plain_ms, b, None, None, f"K={K} V={V}")
        RESULTS[name].update(
            index_mismatches=mismatches,
            max_abs_err_of="logit gap between kernel and plain argmax")
        del p
    torch.cuda.empty_cache()


#: the grids of (q|k|v, o, gate|up, down) the quantized stack is checked on:
#: one grid throughout, and the mix of a Q4_K file (Q6_K ffn_down → int8)
STACK_GRIDS = {"q8": ("q8",) * 4, "q4": ("q4",) * 4,
               "gguf": ("q4", "q4", "q4", "q8")}


def check_stack(pos: int, n_layers: int, grids: str, timed: bool) -> None:
    """A fused decode stack over `n_layers` of Qwen3-0.6B's layers (seeded
    bf16 weights as the engine phase makes them; with `grids` in
    STACK_GRIDS packed on those grids for the quantized stack, with "bf16"
    left dense for the bf16 one), a 2048-row cache with random rows, the
    token at `pos`: hidden state and the written cache rows against the
    plain version (f32, the same bf16 inputs); rows other than `pos`
    untouched; a repeat bit-equal; on the grids, zeroed down scales fail
    the bound.  Timed: device ms, the bound and GB/s of weights."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops import fused_layer
    from aha_tpu_torch.studies.stack_parts import pack_layers

    quant = grids != "bf16"
    name = "fused_decode_stack_q8" if quant else "fused_decode_stack"
    kernel = getattr(fused_layer, name)
    plain = getattr(fused_layer, name + "_plain")
    cfg = Qwen3Config(num_hidden_layers=n_layers)
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(
        (13 if quant else 11) + pos)
    lyr = fuse_decode_params(model.init_random(g, dtype=torch.bfloat16))[
        "layers"]
    if quant:
        lyr = pack_layers(lyr, STACK_GRIDS[grids])
    S, HD = 2048, cfg.num_key_value_heads * cfg.head_dim
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn((1, 1, cfg.hidden_size), generator=g, **bf)
    k = torch.randn((n_layers, 1, S, HD), generator=g, **bf)
    v = torch.randn((n_layers, 1, S, HD), generator=g, **bf)
    kp, vp = k.clone(), v.clone()
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    cos = torch.cat([model.cos[pos], model.cos[pos]])[None]
    sin = torch.cat([model.sin[pos], model.sin[pos]])[None]
    eps = cfg.rms_norm_eps
    got = kernel(x, lyr, p, cos, sin, k, v, eps)
    again = kernel(x, lyr, p, cos, sin, k, v, eps)     # rewrites row pos alike
    ref = plain(x, lyr, p, cos, sin, kp, vp, eps)
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{name} {grids} L={n_layers} pos={pos}: "
            "a repeat is not bit-equal")
    err_x = _rel(got, ref)
    err_kv = max(_rel(k[:, 0, pos], kp[:, 0, pos]),
                 _rel(v[:, 0, pos], vp[:, 0, pos]))
    keep = torch.arange(S, device="cuda") != pos
    require(torch.equal(k[:, :, keep], kp[:, :, keep])
            and torch.equal(v[:, :, keep], vp[:, :, keep]),
            f"{name} touched cache rows other than pos")
    tol = (TOL_FUSED_REL if not quant or n_layers == 1
           else TOL_FUSED_Q8_DEEP_REL[grids])
    require(err_x <= tol and err_kv <= tol,
            f"{name} {grids} L={n_layers} pos={pos}: hidden err {err_x}, "
            f"cache-row err {err_kv} of max |ref| (tol {tol})")
    abs_err = (got.float() - ref.float()).abs().max().item()
    line = (f"[kernels] {name} {grids} L={n_layers} H={cfg.hidden_size} "
            f"pos={pos} (cache 2048): hidden err {err_x:.3e}, cache-row err "
            f"{err_kv:.3e} of max |ref| (tol {tol}); max_abs_err "
            f"{abs_err:.3e}; a repeat bit-equal")
    if quant:
        dn = lyr["mlp"]["down"]
        zeroed = {**lyr, "mlp": {**lyr["mlp"], "down": {
            key: torch.zeros_like(t) if key in ("st", "s4") else t
            for key, t in dn.items()}}}
        err_bad = _rel(plain(x, zeroed, p, cos, sin, kp.clone(), vp.clone(),
                             eps), ref)
        require(err_bad > tol, f"{name}: zeroed down scales pass ({err_bad})")
        line += f"; {STACK_GRIDS[grids]}, zeroed down scales {err_bad:.3g}"
    if timed:
        ms = device_ms(lambda: kernel(x, lyr, p, cos, sin, k, v, eps),
                       iters=20)
        plain_ms = device_ms(lambda: plain(x, lyr, p, cos, sin, kp, vp, eps),
                             iters=3, warmup=1)
        wbytes = _nbytes(lyr)
        live = pos * n_layers * HD * 2 * 2          # K and V rows read
        attn_ops = 4 * cfg.num_attention_heads * pos * cfg.head_dim * n_layers
        if quant:
            weights = sum(t.numel() * (2 if t.dtype == torch.uint8 else 1)
                          for t in _leaves(lyr) if not t.is_floating_point())
            b = bound(wbytes + live, 2 * weights + attn_ops, "int8")
        else:
            b = bound(wbytes + live,
                      2 * sum(t.numel() for t in _leaves(lyr)) + attn_ops)
        line += (f"; device ms/call kernel {ms:.4f} plain {plain_ms:.4f}; "
                 f"bound {b[0]:.4f} ({b[1]}); {wbytes / ms / 1e6:.1f} GB/s "
                 f"of weights")
        if grids in ("bf16", "q8"):
            _record(name, abs_err, ms, plain_ms, b, None, None,
                    f"{grids} L={n_layers} pos={pos}")
            RESULTS[name]["weight_gb_s"] = wbytes / ms / 1e6
    _record(name, abs_err)
    log(line)
    del lyr, k, v, kp, vp
    torch.cuda.empty_cache()

def check_fused_layer() -> None:
    """The one-layer fused decode block (no model path runs it) at
    Qwen3-0.6B's widths, 28 stacked layers of seeded bf16 weights, a
    2048-row cache, pos 1000, window 2048: layers 0 and 27 against the
    plain version (x_out, k_row, v_row within TOL_FUSED_REL of max |ref|),
    the caches untouched; then 28 chained launches, the caller writing each
    layer's rows, against the fused stack's plain version (TOL_CHAIN_REL).
    Device time per call over the 28 layers in turn (one layer's 31.5 MB of
    weights fits the 50 MB L2; cycling reads HBM as a step would)."""
    from aha_tpu_torch.models.qwen3 import (Qwen3Config, Qwen3Model,
                                            fuse_decode_params)
    from aha_tpu_torch.ops.fused_layer import (fused_decode_layer,
                                               fused_decode_layer_plain,
                                               fused_decode_stack_plain)

    L, pos, window, S = 28, 1000, 2048, 2048
    cfg = Qwen3Config(num_hidden_layers=L)
    model = Qwen3Model(cfg, max_rope_len=4096, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(56)
    lyr = fuse_decode_params(model.init_random(g, dtype=torch.bfloat16))[
        "layers"]
    H, D = cfg.hidden_size, cfg.head_dim
    HD = cfg.num_key_value_heads * D
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn((1, 1, H), generator=g, **bf)
    k = torch.randn((L, 1, S, HD), generator=g, **bf)
    v = torch.randn((L, 1, S, HD), generator=g, **bf)
    k0, v0 = k.clone(), v.clone()
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    cos = torch.cat([model.cos[pos], model.cos[pos]])[None]
    sin = torch.cat([model.sin[pos], model.sin[pos]])[None]
    eps = cfg.rms_norm_eps
    rel, err = 0.0, 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fused_decode_layer(x, lyr, lt, p, cos, sin, k, v, window, eps)
        ref = fused_decode_layer_plain(x, lyr, lt, p, cos, sin, k, v, window,
                                       eps)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            rel = max(rel, _rel(a, b))
            err = max(err, (a.float() - b.float()).abs().max().item())
    require(rel <= TOL_FUSED_REL, f"fused_decode_layer: err {rel} of max "
            f"|ref| (tol {TOL_FUSED_REL})")
    require(torch.equal(k, k0) and torch.equal(v, v0),
            "fused_decode_layer wrote the cache")
    # the chain: L launches, the caller writing each layer's rows at pos
    layers = [torch.tensor(i, dtype=torch.int32, device="cuda")
              for i in range(L)]
    h = x
    for li in range(L):
        h, kr, vr = fused_decode_layer(h, lyr, layers[li], p, cos, sin, k0,
                                       v0, window, eps)
        k0[li, 0, pos] = kr.reshape(HD)
        v0[li, 0, pos] = vr.reshape(HD)
    want = fused_decode_stack_plain(x, lyr, p, cos, sin, k, v, eps)
    torch.cuda.synchronize()
    rel_chain = _rel(h, want)
    rel_rows = max(_rel(k0[:, 0, pos], k[:, 0, pos]),
                   _rel(v0[:, 0, pos], v[:, 0, pos]))
    require(rel_chain <= TOL_CHAIN_REL and rel_rows <= TOL_CHAIN_REL,
            f"28 chained fused_decode_layer launches vs the stack: hidden "
            f"{rel_chain}, rows {rel_rows} of max |ref| (tol {TOL_CHAIN_REL})")
    del k0, v0
    layer = _layer_cycle(L)
    ms = device_ms(lambda: fused_decode_layer(x, lyr, layer(), p, cos, sin,
                                              k, v, window, eps), iters=56)
    plain_ms = device_ms(lambda: fused_decode_layer_plain(
        x, lyr, layer(), p, cos, sin, k, v, window, eps), iters=28)
    rows = min(pos, window)
    wbytes = _nbytes(lyr) // L
    b = bound(wbytes + rows * HD * 2 * 2 + 2 * H * 2 + 2 * HD * 2,
              2 * sum(t.numel() for t in _leaves(lyr)) // L
              + 4 * cfg.num_attention_heads * rows * D)
    log(f"[kernels] fused_decode_layer L={L} H={H} pos={pos} window={window}"
        f": err {rel:.3e} of max |ref| (tol {TOL_FUSED_REL}), max_abs_err "
        f"{err:.3e}, caches untouched; 28 chained launches vs the stack's "
        f"plain version: hidden {rel_chain:.3e}, rows {rel_rows:.3e} (tol "
        f"{TOL_CHAIN_REL}); device ms/call kernel {ms:.4f} plain "
        f"{plain_ms:.4f}; bound {b[0]:.4f} ({b[1]}); "
        f"{wbytes / ms / 1e6:.1f} GB/s of weights")
    _record("fused_decode_layer", err, ms, plain_ms, b, None, None,
            f"one of L={L} layers, pos={pos} window={window}")
    RESULTS["fused_decode_layer"].update(rel_err=rel, chain_rel_err=rel_chain)
    del lyr, k, v
    torch.cuda.empty_cache()


#: (n2)'s patch bucket: 4,900 patches of a 980 x 980 image, 1,500 pad rows
VL_BUCKET, VL_GRID, VL_REAL = 6400, (1, 70, 70), 4900


def vl_segments() -> dict[str, np.ndarray]:
    """The window and full-image seg ids of (n2)'s bucket (the published
    tower's 112-pixel windows over 70 x 70 patches), pad rows −1."""
    from aha_tpu_torch.models.qwen2_5vl import VisionConfig, vision_geometry

    geo = vision_geometry([VL_GRID], VisionConfig())
    pad = -np.ones(VL_BUCKET - VL_REAL, np.int32)
    return {"window": np.concatenate([geo["window_seg"], pad]),
            "full": np.concatenate([geo["full_seg"], pad])}


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, the same relative to max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.abs().max().item()


def check_segmented() -> None:
    """The segment kernel at (n2)'s shape (S 6400, H 16, D 80), q/k/v the
    strided thirds of one fused qkv product as the tower hands them, once
    with the window segments and once with the full-image one: error
    against the f32 plain version on every row (pad rows give 0), within
    TOL_SEG_REL of max |ref|; a planted fault — the k tile of rows
    2816-2879, which a window straddles, hidden from every other row, as a
    block that left it off its list would — must break that bound; a
    repeat is bit-equal.  Then device time of kernel and
    plain, the bound, and F.scaled_dot_product_attention with the boolean
    (S, S) mask (timed only)."""
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops.attention import segment_mask

    S, H, D, R = VL_BUCKET, 16, 80, VL_REAL
    g = torch.Generator(device="cuda").manual_seed(80)
    qkv = torch.randn((1, S, 3, H, D), generator=g, device="cuda")
    qkv[:, :, 0] *= 4                       # peaked scores: O(1) outputs
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (qkv[:, :, i] for i in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t0 = 44 * 64
    outside = torch.ones(S, dtype=torch.bool, device="cuda")
    outside[t0:t0 + 64] = False
    for kind, seg_np in vl_segments().items():
        seg = torch.from_numpy(seg_np).cuda()
        got = fa.flash_attention_segmented(q, k, v, seg)
        again = fa.flash_attention_segmented(q, k, v, seg)
        ref = fa.flash_attention_segmented_plain(q.float(), k.float(),
                                                 v.float(), seg)
        hidden = seg.clone()
        hidden[t0:t0 + 64] = 1 << 30        # a seg no other row has
        bad = fa.flash_attention_segmented(q, k, v, hidden)
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"segmented {kind}: a repeat is not bit-equal")
        err, rel = _rel_err(got, ref)
        _, rel_bad = _rel_err(bad[:, outside], ref[:, outside])
        require(rel <= TOL_SEG_REL,
                f"segmented {kind}: err {rel} of max |ref|")
        require(rel_bad > TOL_SEG_REL, f"segmented {kind}: a hidden k tile "
                f"stays within the bound ({rel_bad} of max |ref|)")
        ms = device_ms(lambda: fa.flash_attention_segmented(q, k, v, seg))
        # the real rows alone: a bucket's pad tail should cost ~nothing
        real = [t[:, :R] for t in (q, k, v)] + [seg[:R]]
        ms_real = device_ms(lambda: fa.flash_attention_segmented(*real))
        plain_ms = device_ms(lambda: fa.flash_attention_segmented_plain(
            q, k, v, seg), iters=5, warmup=1)
        mask = segment_mask(seg, seg.device)
        lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, attn_mask=mask))
        # real rows' q, k, v read once, every output row written once; the
        # pairs with equal seg ≥ 0
        pairs = int((np.bincount(seg_np[seg_np >= 0]).astype(np.int64) ** 2
                     ).sum())
        b = bound((3 * R + S) * H * D * 2, 4 * H * D * pairs)
        log(f"[kernels] segmented {kind} S={S} ({R} real + {S - R} pad) "
            f"H={H} D={D}, strided qkv: max_abs_err {err:.3e}, {rel:.3e} of "
            f"max |ref| (tol {TOL_SEG_REL}; a hidden k tile {rel_bad:.3e}), "
            f"a repeat bit-equal; {pairs} pairs; device ms/call kernel {ms:.4f} (the {R} real rows "
            f"alone {ms_real:.4f}) plain {plain_ms:.4f} masked sdpa "
            f"{lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
        if kind == "window":
            _record("flash_attention_segmented", err, ms, plain_ms, b, lib_ms,
                    "F.scaled_dot_product_attention, boolean (S, S) mask",
                    f"window segments S={S} H={H} D={D} (28 of 32 blocks)")
        else:
            _record("flash_attention_segmented", err)
            RESULTS["flash_attention_segmented"]["full_image"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib_ms,
                "real_rows_ms": ms_real,
                "timed_at": f"full-image segment S={S} (4 of 32 blocks)"}
        r = RESULTS["flash_attention_segmented"]
        r["rel_err"] = max(r.get("rel_err", 0.0), rel)
        if kind == "window":
            r["real_rows_ms"] = ms_real
        del ref, got, bad, mask
    del qkv, qt, kt, vt
    torch.cuda.empty_cache()


#: Qwen3-VL-8B's tower at the segment kernel: 16 heads of 72, a 4096-row
#: patch bucket holding (a) one 1024 x 1024 image (64 x 64 patches, one
#: segment) or (b) the 8-frame 448 x 448 video (4 frame segments of 28 x 28
#: patches, 3,136 real rows and 960 pad)
VL3_SEG_CASES = {"image": (1, 4096), "video": (4, 784)}
VL3_BUCKET = 4096


def vl3_segments(kind: str) -> np.ndarray:
    frames, rows = VL3_SEG_CASES[kind]
    seg = np.repeat(np.arange(frames, dtype=np.int32), rows)
    return np.concatenate([seg, -np.ones(VL3_BUCKET - len(seg), np.int32)])


def _tail_from_next_head(qkv: torch.Tensor, D: int, extra: int):
    """The fault the D 72 tensor maps must not make: each head's q and k
    read `extra` columns past D, from the next head of the fused qkv row
    (q head 15 into k head 0, k head 15 into v head 0), as a tail box
    whose map extent were the row stride would.  (q, k) of width
    D + extra, in f32."""
    B, S, _, H, _ = qkv.shape
    flat = qkv.float().reshape(B, S, 3 * H * D)
    wide = [torch.stack([flat[..., (part * H + h) * D:
                              (part * H + h) * D + D + extra]
                         for h in range(H)], dim=2) for part in (0, 1)]
    return wide[0], wide[1]


def check_segmented_d72() -> None:
    """The segment kernel's D 72 instance at Qwen3-VL-8B's tower (H 16, D
    72), q/k/v the strided thirds of one fused qkv product whose heads
    differ, in the two cases of VL3_SEG_CASES: error against the f32 plain
    version on every row, within TOL_SEG_REL of max |ref|; a repeat
    bit-equal; two planted faults the bound must reject — a k tile hidden
    from every other row (a tile left off a list), and every score taking
    8 more columns from the next head (a tail box read past D); device ms
    of kernel and plain, the bound, and F.scaled_dot_product_attention
    with the boolean (S, S) mask (and, for the one-segment image, without
    a mask)."""
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops.attention import segment_mask

    S, H, D = VL3_BUCKET, 16, 72
    out = RESULTS["flash_attention_segmented"].setdefault("d72", {})
    for kind, (frames, rows) in VL3_SEG_CASES.items():
        R = frames * rows
        seg_np = vl3_segments(kind)
        seg = torch.from_numpy(seg_np).cuda()
        g = torch.Generator(device="cuda").manual_seed(72 + frames)
        qkv = torch.randn((1, S, 3, H, D), generator=g, device="cuda")
        qkv[:, :, 0] *= 4                   # peaked scores: O(1) outputs
        qkv = qkv.to(torch.bfloat16)
        q, k, v = (qkv[:, :, i] for i in range(3))
        n0 = fa.flash_attention_segmented.launches
        got = fa.flash_attention_segmented(q, k, v, seg)
        again = fa.flash_attention_segmented(q, k, v, seg)
        require(fa.flash_attention_segmented.launches == n0 + 2,
                "the D 72 segment call did not launch the kernel")
        ref = fa.flash_attention_segmented_plain(q.float(), k.float(),
                                                 v.float(), seg)
        t0 = 5 * 64                         # a k tile inside frame 0
        hidden = seg.clone()
        hidden[t0:t0 + 64] = 1 << 30
        outside = torch.ones(S, dtype=torch.bool, device="cuda")
        outside[t0:t0 + 64] = False
        bad_tile = fa.flash_attention_segmented(q, k, v, hidden)
        q80, k80 = _tail_from_next_head(qkv, D, 8)
        v80 = torch.cat([v.float(), torch.zeros_like(v.float()[..., :8])],
                        -1)
        bad_tail = fa.flash_attention_segmented_plain(
            q80, k80, v80, seg, scale=D ** -0.5)[..., :D]
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"segmented D 72 {kind}: a repeat is not bit-equal")
        err, rel = _rel_err(got, ref)
        _, rel_tile = _rel_err(bad_tile[:, outside], ref[:, outside])
        _, rel_tail = _rel_err(bad_tail, ref)
        require(rel <= TOL_SEG_REL,
                f"segmented D 72 {kind}: err {rel} of max |ref|")
        require(rel_tile > TOL_SEG_REL, f"segmented D 72 {kind}: a hidden "
                f"k tile stays within the bound ({rel_tile})")
        require(rel_tail > TOL_SEG_REL, f"segmented D 72 {kind}: a tail "
                f"read from the next head stays within the bound "
                f"({rel_tail})")
        ms = device_ms(lambda: fa.flash_attention_segmented(q, k, v, seg))
        plain_ms = device_ms(lambda: fa.flash_attention_segmented_plain(
            q, k, v, seg), iters=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = segment_mask(seg, seg.device)
        lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, attn_mask=mask))
        lib_nomask_ms = (device_ms(lambda: _sdpa(qt, kt, vt))
                         if kind == "image" else None)
        pairs = int((np.bincount(seg_np[seg_np >= 0]).astype(np.int64) ** 2
                     ).sum())
        b = bound((3 * R + S) * H * D * 2, 4 * H * D * pairs)
        nomask = (f", unmasked sdpa {lib_nomask_ms:.4f}"
                  if lib_nomask_ms is not None else "")
        log(f"[kernels] segmented D 72 {kind} S={S} ({R} real + {S - R} pad, "
            f"{frames} segment(s)) H={H}, strided qkv: max_abs_err "
            f"{err:.3e}, {rel:.3e} of max |ref| (tol {TOL_SEG_REL}; a hidden "
            f"k tile {rel_tile:.3e}, a tail read from the next head "
            f"{rel_tail:.3e}), a repeat bit-equal; {pairs} pairs; device "
            f"ms/call kernel {ms:.4f} plain {plain_ms:.4f} masked sdpa "
            f"{lib_ms:.4f}{nomask}; bound {b[0]:.4f} ({b[1]}) | "
            f"{card_line()}")
        _record("flash_attention_segmented", err)
        out[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "library_ms": lib_ms,
                     "library_unmasked_ms": lib_nomask_ms, "rel_err": rel,
                     "rel_err_hidden_tile": rel_tile,
                     "rel_err_tail_from_next_head": rel_tail,
                     "timed_at": f"S={S} ({R} real) H={H} D={D}, {frames} "
                                 f"segment(s)"}
        del qkv, qt, kt, vt, ref, got, again, bad_tile, bad_tail, mask
        del q80, k80, v80
    torch.cuda.empty_cache()


#: PaddleOCR-VL's tower at the segment kernel: an A4 page at 150 dpi
#: (1,240 x 1,754 px, resized to 1,232 x 1,764: 88 x 126 patches of 14 px),
#: one segment of 11,088 rows in the 16,384-row patch bucket, 16 heads of
#: 72 as three separate contiguous (1, S, 16, 72) tensors (the tower's q, k
#: and v linears)
PAGE_BUCKET, PAGE_REAL = 16384, 11088
#: q rows a chunk of the page's plain version (the whole would hold 17 GB
#: of f32 scores)
PAGE_CHUNK = 1024


def _segment_plain_chunked(q, k, v, seg, rows: int = PAGE_CHUNK):
    """flash_attention_segmented_plain in chunks of `rows` q rows: f32
    masked sdpa of each chunk against every key, a pad row's output 0."""
    from aha_tpu_torch.ops.attention import sdpa

    S = q.shape[1]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    kf, vf = k.float(), v.float()
    for r0 in range(0, S, rows):
        sq = seg[r0:r0 + rows]
        mask = ((sq[:, None] == seg[None, :]) & (seg[None, :] >= 0))
        o = sdpa(q[:, r0:r0 + rows].float(), kf, vf, mask[None, None])
        out[:, r0:r0 + rows] = torch.where((sq >= 0)[None, :, None, None],
                                           o, 0.0)
    return out


def _tail_past_head(t: torch.Tensor, extra: int) -> torch.Tensor:
    """The fault the D 72 tensor maps must not make on a contiguous
    (B, S, H, D) tensor: each head read `extra` columns past D — the next
    head's first columns, head H - 1 the next row's head 0 (zeros past the
    last row) — as a tail box whose map extent were the row stride would.
    (B, S, H, D + extra) in f32."""
    B, S, H, D = t.shape
    flat = torch.cat([t.float().reshape(-1),
                      t.new_zeros(extra, dtype=torch.float32)])
    return flat.as_strided((B, S, H, D + extra), (S * H * D, H * D, D, 1))


def check_segmented_page() -> None:
    """The segment kernel's D 72 instance at PaddleOCR-VL's tower and page:
    S 16,384 with one segment of PAGE_REAL rows and 5,296 pad rows (seg
    −1), 16 heads of 72, q / k / v three separate contiguous tensors whose
    heads differ (87 real k tiles of 128; each head's tail box sits just
    before the next head's columns).  Every row against the f32 plain
    version computed in chunks of PAGE_CHUNK q rows, within TOL_SEG_REL of
    max |ref|; a repeat bit-equal; two planted faults the bound must
    reject — a k tile hidden from every other row, and every head's q and
    k reading 8 columns past D from the next head; device ms of the kernel,
    of the chunked plain version, of unmasked F.scaled_dot_product_attention
    on the 11,088 real rows alone, and the bound (4 · R² · 72 · 16 flop at
    the bf16 peak)."""
    from aha_tpu_torch.ops import flash_attention as fa

    S, R, H, D = PAGE_BUCKET, PAGE_REAL, 16, 72
    seg = torch.cat([torch.zeros(R, dtype=torch.int32),
                     -torch.ones(S - R, dtype=torch.int32)]).cuda()
    g = torch.Generator(device="cuda").manual_seed(1754)
    q = (torch.randn((1, S, H, D), generator=g, device="cuda") * 4).bfloat16()
    k = torch.randn((1, S, H, D), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, S, H, D), generator=g, device="cuda").bfloat16()
    require(all(t.is_contiguous() for t in (q, k, v)),
            "the page's q/k/v are not contiguous")
    n0 = fa.flash_attention_segmented.launches
    got = fa.flash_attention_segmented(q, k, v, seg)
    again = fa.flash_attention_segmented(q, k, v, seg)
    require(fa.flash_attention_segmented.launches == n0 + 2,
            "the page's segment call did not launch the kernel")
    ref = _segment_plain_chunked(q, k, v, seg)
    t0 = 40 * 128 + 64                      # a k tile inside the segment
    hidden = seg.clone()
    hidden[t0:t0 + 64] = 1 << 30
    outside = torch.ones(S, dtype=torch.bool, device="cuda")
    outside[t0:t0 + 64] = False
    bad_tile = fa.flash_attention_segmented(q, k, v, hidden)
    q80, k80 = _tail_past_head(q, 8), _tail_past_head(k, 8)
    v80 = torch.cat([v.float(), torch.zeros_like(v.float()[..., :8])], -1)
    bad_tail = _segment_plain_chunked(q80, k80, v80, seg)[..., :D]
    torch.cuda.synchronize()
    require(torch.equal(got, again), "segmented page: a repeat is not "
            "bit-equal")
    require(bool((got[:, R:] == 0).all()), "segmented page: a pad row's "
            "output is not 0")
    err, rel = _rel_err(got, ref)
    _, rel_tile = _rel_err(bad_tile[:, outside], ref[:, outside])
    _, rel_tail = _rel_err(bad_tail, ref)
    del bad_tile, bad_tail, q80, k80, v80, ref, again
    require(rel <= TOL_SEG_REL, f"segmented page: err {rel} of max |ref|")
    require(rel_tile > TOL_SEG_REL, f"segmented page: a hidden k tile stays "
            f"within the bound ({rel_tile})")
    require(rel_tail > TOL_SEG_REL, f"segmented page: a tail read from the "
            f"next head stays within the bound ({rel_tail})")
    ms = device_ms(lambda: fa.flash_attention_segmented(q, k, v, seg),
                   iters=10)
    plain_ms = device_ms(lambda: _segment_plain_chunked(q, k, v, seg),
                         iters=2, warmup=1)
    qt, kt, vt = (t[:, :R].transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = device_ms(lambda: _sdpa(qt, kt, vt), iters=10)
    b = bound((3 * R + S) * H * D * 2, 4 * H * D * R * R)
    log(f"[kernels] segmented D 72 page S={S} ({R} real + {S - R} pad, one "
        f"segment) H={H}, contiguous q/k/v: max_abs_err {err:.3e}, "
        f"{rel:.3e} of max |ref| (tol {TOL_SEG_REL}; plain in chunks of "
        f"{PAGE_CHUNK} q rows; a hidden k tile {rel_tile:.3e}, a tail read "
        f"from the next head {rel_tail:.3e}), a repeat bit-equal; device "
        f"ms/call kernel {ms:.4f} plain (chunked) {plain_ms:.4f} unmasked "
        f"sdpa on the {R} real rows {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]}) "
        f"| {card_line()}")
    _record("flash_attention_segmented", err)
    RESULTS["flash_attention_segmented"]["page"] = {
        "ms": ms, "plain_ms": plain_ms, "plain": f"chunks of {PAGE_CHUNK} q "
        "rows", "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
        "library": f"F.scaled_dot_product_attention, unmasked, the {R} real "
                   "rows", "rel_err": rel, "rel_err_hidden_tile": rel_tile,
        "rel_err_tail_from_next_head": rel_tail,
        "timed_at": f"S={S} ({R} real, one segment) H={H} D={D}, contiguous "
                    f"q/k/v"}
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()


#: Fun-ASR-Nano's two shapes at the segment kernel (D 128), (ac1)'s 30 s:
#: the SANM blocks' S 512 bucket of 500 LFR rows at 4 heads (q and k the
#: strided thirds of the fused q|k|v product, v the pad-zeroed copy), the
#: adaptor's S 256 of 250 rows at 8 heads (three contiguous tensors)
FUN_ASR_SEG = {"sanm": dict(S=512, real=500, H=4, fused=True),
               "adaptor": dict(S=256, real=250, H=8, fused=False)}


def check_segmented_fun_asr() -> None:
    """Row 10 at FUN_ASR_SEG's two shapes: every row against the f32 plain
    version within TOL_SEG_REL of max |ref| (pad rows 0), a repeat
    bit-equal, and the planted fault the bound must reject (the k tile of
    rows 128-191 hidden from every other row); device ms of the kernel and
    its plain version, the bound, and F.scaled_dot_product_attention over
    the real rows with the boolean mask and without one."""
    from aha_tpu_torch.ops import flash_attention as fa
    from aha_tpu_torch.ops.attention import segment_mask

    D = 128
    out = {}
    for kind, c in FUN_ASR_SEG.items():
        S, R, H = c["S"], c["real"], c["H"]
        seg = torch.cat([torch.zeros(R, dtype=torch.int32),
                         -torch.ones(S - R, dtype=torch.int32)]).cuda()
        g = torch.Generator(device="cuda").manual_seed(S + H)
        if c["fused"]:
            qkv = torch.randn((1, S, 3 * H * D), generator=g, device="cuda")
            qkv[..., :H * D] *= 4               # peaked scores: O(1) outputs
            qkv = qkv.bfloat16()
            q = qkv[..., :H * D].reshape(1, S, H, D)
            k = qkv[..., H * D:2 * H * D].reshape(1, S, H, D)
            v = torch.where((seg >= 0)[None, :, None], qkv[..., 2 * H * D:],
                            0.0).reshape(1, S, H, D)
            require(not q.is_contiguous() and not k.is_contiguous()
                    and v.is_contiguous(), f"{kind}: q/k are not strided "
                    "thirds of one product")
        else:
            q = (torch.randn((1, S, H, D), generator=g, device="cuda")
                 * 4).bfloat16()
            k = torch.randn((1, S, H, D), generator=g,
                            device="cuda").bfloat16()
            v = torch.randn((1, S, H, D), generator=g,
                            device="cuda").bfloat16()
        n0 = fa.flash_attention_segmented.launches
        got = fa.flash_attention_segmented(q, k, v, seg)
        again = fa.flash_attention_segmented(q, k, v, seg)
        require(fa.flash_attention_segmented.launches == n0 + 2,
                f"segmented {kind}: the kernel was not launched")
        ref = fa.flash_attention_segmented_plain(q.float(), k.float(),
                                                 v.float(), seg)
        t0 = 128
        hidden = seg.clone()
        hidden[t0:t0 + 64] = 1 << 30
        outside = torch.ones(S, dtype=torch.bool, device="cuda")
        outside[t0:t0 + 64] = False
        bad = fa.flash_attention_segmented(q, k, v, hidden)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"segmented {kind}: a repeat is "
                "not bit-equal")
        require(bool((got[:, R:] == 0).all()), f"segmented {kind}: a pad "
                "row's output is not 0")
        err, rel = _rel_err(got, ref)
        _, rel_bad = _rel_err(bad[:, outside], ref[:, outside])
        require(rel <= TOL_SEG_REL, f"segmented {kind}: err {rel} of max "
                "|ref|")
        require(rel_bad > TOL_SEG_REL, f"segmented {kind}: a hidden k tile "
                f"stays within the bound ({rel_bad})")
        ms = device_ms(lambda: fa.flash_attention_segmented(q, k, v, seg))
        plain_ms = device_ms(lambda: fa.flash_attention_segmented_plain(
            q, k, v, seg), iters=10)
        mask = segment_mask(seg, seg.device)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        masked_ms = device_ms(lambda: _sdpa(qt, kt, vt, attn_mask=mask))
        qr, kr, vr = (t[:, :, :R].contiguous() for t in (qt, kt, vt))
        lib_ms = device_ms(lambda: _sdpa(qr, kr, vr))
        b = bound((3 * R + S) * H * D * 2, 4 * H * D * R * R)
        log(f"[kernels] segmented D 128 Fun-ASR {kind} S={S} ({R} real + "
            f"{S - R} pad, one segment) H={H}, "
            f"{'strided q|k|v thirds' if c['fused'] else 'contiguous q/k/v'}: "
            f"max_abs_err {err:.3e}, {rel:.3e} of max |ref| (tol "
            f"{TOL_SEG_REL}; a hidden k tile {rel_bad:.3e}), a repeat "
            f"bit-equal; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
            f"masked sdpa {masked_ms:.4f} unmasked sdpa on the {R} real rows "
            f"{lib_ms:.4f}; bound {b[0]:.4f} ({b[1]}) | {card_line()}")
        _record("flash_attention_segmented", err)
        out[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "library_ms": lib_ms,
                     "library": f"F.scaled_dot_product_attention, unmasked, "
                                f"the {R} real rows",
                     "masked_sdpa_ms": masked_ms, "rel_err": rel,
                     "rel_err_hidden_tile": rel_bad,
                     "timed_at": f"S={S} ({R} real, one segment) H={H} "
                                 f"D={D}"}
        del q, k, v, qt, kt, vt, qr, kr, vr, got, again, ref, bad, mask
    RESULTS["flash_attention_segmented"]["fun_asr"] = out
    torch.cuda.empty_cache()


#: ERNIE-4.5-0.3B (PaddleOCR-VL's decoder) at the decode kernel: 18 layers,
#: 16 query heads over 2 of 128, (y1)'s rows in the 4,096-row cache
ERNIE_DECODE = dict(L=18, S=4096, Hq=16, Hkv=2, D=128, valid=2900)
#: row 8 at DeepSeek-OCR's decoder (12 layers, 10 heads of 128 over 10:
#: G 1) in (aa2)'s 1024-row cache, at about (aa1)'s and (aa2)'s live rows
DSOCR_DECODE = {"dsocr_300": dict(L=12, S=1024, Hq=10, Hkv=10, D=128,
                                  valid=300),
                "dsocr_920": dict(L=12, S=1024, Hq=10, Hkv=10, D=128,
                                  valid=920)}


def check_stacked_at(key: str, label: str, c: dict, seed: int) -> None:
    """flash_decode_at_layer at the shape `c`: error against the plain
    version on the first and last layer, within TOL_DECODE_REL of max |ref|,
    a live length off by one either way past it; device time over the L
    layers in turn, plain, the bound and sdpa over the live rows, kept
    under RESULTS["flash_decode_at_layer"][key]."""
    from aha_tpu_torch.ops import flash_attention as fa

    L, S, Hq, Hkv, D, valid = (c[n] for n in ("L", "S", "Hq", "Hkv", "D",
                                              "valid"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _planted_decode_cache(g, L, S, Hq, Hkv, D, valid)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    rel, rel_bad, err = 0.0, float("inf"), 0.0
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             lt, vl)
        e, r = _rel_err(fa.flash_decode_at_layer(q, k, v, lt, vl), ref)
        err, rel = max(err, e), max(rel, r)
        for off in (-1, 1):
            rel_bad = min(rel_bad, _rel_err(fa.flash_decode_at_layer(
                q, k, v, lt, vl + off), ref)[1])
    require(rel <= TOL_DECODE_REL, f"{label} decode: err {rel} of max |ref|")
    require(rel_bad > TOL_DECODE_REL, f"{label} decode: a live length off by "
            f"one stays within the bound ({rel_bad})")
    layer = _layer_cycle(L)
    ms = device_ms(lambda: fa.flash_decode_at_layer(q, k, v, layer(), vl),
                   iters=4 * L)
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_plain(
        q, k, v, layer(), vl), iters=2 * L)
    it = iter(range(10 ** 9))
    kv_live = [(k[li, :, :valid].transpose(1, 2).contiguous(),
                v[li, :, :valid].transpose(1, 2).contiguous())
               for li in range(L)]
    qt = q.transpose(1, 2).contiguous()
    lib_ms = device_ms(lambda: _sdpa(qt, *kv_live[next(it) % L]),
                       iters=4 * L)
    b = bound(valid * Hkv * D * 2 * 2 + 2 * Hq * D * 2, 4 * Hq * valid * D)
    log(f"[kernels] flash_decode_at_layer {label} L={L} S={S} "
        f"valid={valid} Hq={Hq} Hkv={Hkv} D={D}: max_abs_err {err:.3e}, "
        f"{rel:.3e} of max |ref| (tol {TOL_DECODE_REL}; live length ±1 ≥ "
        f"{rel_bad:.3e}); device ms/call kernel {ms:.4f} plain "
        f"{plain_ms:.4f} sdpa {lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
    _record("flash_decode_at_layer", err)
    RESULTS["flash_decode_at_layer"][key] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
        "library_ms": lib_ms, "rel_err": rel,
        "timed_at": f"L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}"}
    del q, k, v, kv_live, qt
    torch.cuda.empty_cache()


def check_ernie_decode() -> None:
    """Row 8 at ERNIE-4.5's decoder (PaddleOCR-VL's step)."""
    check_stacked_at("ernie", "ERNIE-4.5-0.3B", ERNIE_DECODE, 18)


def check_dsocr_attention() -> None:
    """Rows 1 and 8 at DeepSeek-OCR's 10 heads of 128 over 10 (G 1): the
    prefill kernel at (aa1)'s and (aa2)'s prompt buckets (S 512, 1024,
    causal) beside sdpa, the stacked decode at DSOCR_DECODE."""
    check_prefill(512, True, timed=True, Hkv=10, Hq=10)
    check_prefill(1024, True, timed=True, Hkv=10, Hq=10)
    for i, (key, c) in enumerate(DSOCR_DECODE.items()):
        check_stacked_at(key, "DeepSeek-OCR", c, 19 + i)


def _planted_decode_cache(g, L: int, S: int, Hq: int, Hkv: int, D: int,
                          valid: int, dtype: torch.dtype = torch.bfloat16):
    """q and a (L, 1, S, Hkv, D) cache at N(0, 1) in `dtype`, with one key
    per kv head planted at the last live row along its query heads' summed
    direction — scored ~7 against the ~7.4 log-sum of the other 999 rows,
    so it carries ~0.1-0.9 of each query head's weight — and a dead row at
    `valid` (where S leaves one) planted three times stronger, which would
    swamp a read past the live length."""
    G = Hq // Hkv
    q = torch.randn((1, 1, Hq, D), generator=g, device="cuda")
    k = torch.randn((L, 1, S, Hkv, D), generator=g, device="cuda")
    v = torch.randn((L, 1, S, Hkv, D), generator=g, device="cuda")
    u = q.reshape(Hkv, G, D).sum(1)
    u = u / u.norm(dim=-1, keepdim=True)
    k[:, 0, valid - 1] = 21 * u
    if valid < S:
        k[:, 0, valid] = 63 * u
    return q.to(dtype), k.to(dtype), v.to(dtype)


def check_stacked_decode() -> None:
    """flash_decode_at_layer over the 5-D cache at Qwen2.5-VL-3B's decoder
    (L 36, S 4096, Hq 16 over Hkv 2, D 128, 1000 live rows) and flash_decode
    over one (B, S, Hkv, D) layer of it: errors against the plain versions,
    within TOL_DECODE_REL of max |ref|, and the live length off by one
    either way must break that bound; device time over the 36 layers in
    turn (past the L2, as a step reads them), the bound, and sdpa over the
    live rows (timed only)."""
    from aha_tpu_torch.ops import flash_attention as fa

    L, S, Hq, Hkv, D, valid = 36, 4096, 16, 2, 128, 1000
    g = torch.Generator(device="cuda").manual_seed(36)
    q, k, v = _planted_decode_cache(g, L, S, Hq, Hkv, D, valid)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    err = {"flash_decode_at_layer": 0.0, "flash_decode": 0.0}
    rel = dict(err)
    rel_bad = float("inf")
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             lt, vl)
        runs = {"flash_decode_at_layer": lambda n: fa.flash_decode_at_layer(
                    q, k, v, lt, vl + n),
                "flash_decode": lambda n: fa.flash_decode(q, k[li], v[li],
                                                          vl + n)}
        for name, run in runs.items():
            e, r = _rel_err(run(0), ref)
            err[name], rel[name] = max(err[name], e), max(rel[name], r)
            for off in (-1, 1):
                rel_bad = min(rel_bad, _rel_err(run(off), ref)[1])
    require(max(rel.values()) <= TOL_DECODE_REL,
            f"stacked decode errors {rel} of max |ref|")
    require(rel_bad > TOL_DECODE_REL, f"stacked decode: a live length off "
            f"by one stays within the bound ({rel_bad} of max |ref|)")
    layer = _layer_cycle(L)
    it = iter(range(10 ** 9))

    def cycle() -> int:
        return next(it) % L

    def _on_layer(fn, li: int):
        return fn(q, k[li], v[li], vl)
    runs = {
        "flash_decode_at_layer": (
            lambda: fa.flash_decode_at_layer(q, k, v, layer(), vl),
            lambda: fa.flash_decode_at_layer_plain(q, k, v, layer(), vl)),
        "flash_decode": (
            lambda: _on_layer(fa.flash_decode, cycle()),
            lambda: _on_layer(fa.flash_decode_plain, cycle())),
    }
    kv_live = [(k[li, :, :valid].transpose(1, 2).contiguous(),
                v[li, :, :valid].transpose(1, 2).contiguous())
               for li in range(L)]
    qt = q.transpose(1, 2).contiguous()
    lib_ms = device_ms(lambda: _sdpa(qt, *kv_live[cycle()]), iters=72)
    b = bound(valid * Hkv * D * 2 * 2 + 2 * Hq * D * 2, 4 * Hq * valid * D)
    for name, (kernel, plain) in runs.items():
        ms = device_ms(kernel, iters=72)
        plain_ms = device_ms(plain, iters=72)
        log(f"[kernels] {name} L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} "
            f"D={D}: max_abs_err {err[name]:.3e}, {rel[name]:.3e} of max "
            f"|ref| (tol {TOL_DECODE_REL}; live length ±1 ≥ {rel_bad:.3e}); "
            f"device ms/call kernel {ms:.4f} plain {plain_ms:.4f} sdpa "
            f"{lib_ms:.4f}; bound {b[0]:.4f} ({b[1]})")
        _record(name, err[name], ms, plain_ms, b, lib_ms,
                "F.scaled_dot_product_attention over the live rows",
                f"L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv}"
                if name == "flash_decode_at_layer" else
                f"one (1, {S}, {Hkv}, {D}) layer, valid={valid}")
        RESULTS[name]["rel_err"] = rel[name]
    del k, v, kv_live
    torch.cuda.empty_cache()


def _planted_slots_cache(g, L: int, B: int, S: int, Hq: int, Hkv: int,
                         D: int, lens: tuple[int, ...]):
    """_planted_decode_cache at B slots with per-slot lengths: each slot's
    key planted at its last live row along its query heads' summed
    direction, and a dead row at its length planted three times
    stronger."""
    G = Hq // Hkv
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda")
    k = torch.randn((L, B, S, Hkv, D), generator=g, device="cuda")
    v = torch.randn((L, B, S, Hkv, D), generator=g, device="cuda")
    for b, n in enumerate(lens):
        u = q[b].reshape(Hkv, G, D).sum(1)
        u = u / u.norm(dim=-1, keepdim=True)
        k[:, b, n - 1] = 21 * u
        if n < S:
            k[:, b, n] = 63 * u
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


#: (s)'s decode shape: MiniCPM4-0.5B's 24 layers, 16 query heads over 2, D
#: 64, 8 slots of a 4096-row cache at ragged lengths (a parked slot of 1,
#: the split boundaries 32 and 33, a live row short of the whole cache);
#: (u2)'s and (v2)'s 8-slot steps read the same lengths
MINICPM_RAGGED = (1, 32, 33, 300, 1000, 1500, 2048, 4095)

#: row 8 at the 8-slot steps of the paths that run it over the 5-D cache:
#: JSON key → (label, L attention layers, Hq, Hkv, D, the inputs' seed)
SLOT_DECODE_SHAPES = {
    "minicpm_b8": ("MiniCPM4-0.5B's", 24, 16, 2, 64, 24),
    "lfm2_b8": ("LFM2-1.2B's (u2)", 6, 32, 8, 64, 256),
    "qwen3_5_b8": ("Qwen3.5's (v2)", 6, 16, 2, 128, 224),
}


def check_slots_decode(key: str) -> None:
    """Row 8 (flash_decode_at_layer) as an 8-slot step reads it
    (SLOT_DECODE_SHAPES[key]): the 5-D cache at S 4096, B 8,
    MINICPM_RAGGED; within TOL_DECODE_REL of max |ref| against the plain
    version, every slot's live length off by one rejected by that bound,
    each slot bit-equal to a B = 1 launch on that slot; device time over
    the L layers in turn beside one masked sdpa over each slot's whole
    cache (per-slot length mask) and the bound of the live rows."""
    from aha_tpu_torch.ops import flash_attention as fa

    label, L, Hq, Hkv, D, seed = SLOT_DECODE_SHAPES[key]
    B, S = 8, 4096
    lens = MINICPM_RAGGED
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _planted_slots_cache(g, L, B, S, Hq, Hkv, D, lens)
    vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    err = rel = 0.0
    rel_bad = float("inf")
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fa.flash_decode_at_layer(q, k, v, lt, vl)
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             lt, vl)
        e, r = _rel_err(got, ref)
        err, rel = max(err, e), max(rel, r)
        for off in (-1, 1):
            bad = (vl + off).clamp(1, S)
            rel_bad = min(rel_bad, _rel_err(
                fa.flash_decode_at_layer(q, k, v, lt, bad), ref)[1])
        for b in range(B):
            one = fa.flash_decode_at_layer(
                q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                v[:, b:b + 1].contiguous(), lt, vl[b:b + 1].contiguous())
            require(torch.equal(one, got[b:b + 1]),
                    f"{label} decode slot {b} differs from a B = 1 launch")
    require(rel <= TOL_DECODE_REL, f"{label} decode: {rel} of max |ref| "
            f"(tol {TOL_DECODE_REL})")
    require(rel_bad > TOL_DECODE_REL, f"{label} decode: live lengths off by "
            f"one stay within the bound ({rel_bad} of max |ref|)")
    layer = _layer_cycle(L)
    ms = device_ms(lambda: fa.flash_decode_at_layer(q, k, v, layer(), vl),
                   iters=48)
    plain_ms = device_ms(lambda: fa.flash_decode_at_layer_plain(
        q, k, v, layer(), vl), iters=24)
    live = sum(lens)
    b_ = bound(live * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2,
               4 * Hq * live * D)
    mask = (torch.arange(S, device="cuda")[None, :]
            < vl[:, None]).reshape(B, 1, 1, S)
    qt = q.transpose(1, 2).contiguous()
    kv_t = [(k[li].transpose(1, 2).contiguous(),
             v[li].transpose(1, 2).contiguous()) for li in range(L)]
    it = iter(range(10 ** 9))
    lib_ms = device_ms(lambda: _sdpa(qt, *kv_t[next(it) % L],
                                     attn_mask=mask), iters=48)
    del kv_t
    shape = f"L={L} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D}"
    log(f"[kernels] flash_decode_at_layer at {label} 8-slot step ({shape}, "
        f"lengths {lens}): {rel:.3e} of max |ref| (tol {TOL_DECODE_REL}; "
        f"live lengths ±1 ≥ {rel_bad:.3e}), each slot bit-equal to a B = 1 "
        f"launch; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
        f"masked sdpa {lib_ms:.4f}; bound {b_[0]:.4f} ({b_[1]})")
    _record("flash_decode_at_layer", err)
    RESULTS["flash_decode_at_layer"][key] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_[0], bound_by=b_[1],
        library_ms=lib_ms, rel_err=rel, off_by_one_rel_err=rel_bad,
        library="F.scaled_dot_product_attention, a per-slot length mask "
                "over the whole cache",
        shape=f"{shape} ragged {lens}")
    del q, k, v
    torch.cuda.empty_cache()


def check_prefill_batched() -> None:
    """Row 1 (flash_attention) at B = 4, as an embedding group of rows
    prefills: S 512, Hq 16 over Hkv 8, D 128, causal; within TOL_ATTN of
    the plain version, each batch row bit-equal to a B = 1 launch on it;
    device time beside F.scaled_dot_product_attention and the bound."""
    from aha_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    B, S, Hq, Hkv, D = 4, 512, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(4512)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, S, Hq, D), generator=g, **bf)
    k = torch.randn((B, S, Hkv, D), generator=g, **bf)
    v = torch.randn((B, S, Hkv, D), generator=g, **bf)
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    require(err <= TOL_ATTN, f"prefill B={B}: err {err}")
    for b in range(B):
        one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1])
        require(torch.equal(one, got[b:b + 1]),
                f"prefill B={B}: row {b} differs from a B = 1 launch")
    ms = device_ms(lambda: flash_attention(q, k, v))
    plain_ms = device_ms(lambda: flash_attention_plain(q, k, v), iters=10)
    pairs = S * (S + 1) // 2
    b_ = bound(B * S * (2 * Hq + 2 * Hkv) * D * 2, 4 * B * Hq * pairs * D)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, is_causal=True))
    log(f"[kernels] prefill B={B} S={S} causal Hq={Hq} Hkv={Hkv} D={D}: "
        f"max_abs_err {err:.3e} (tol {TOL_ATTN}), each row bit-equal to a "
        f"B = 1 launch; device ms/call kernel {ms:.4f} plain {plain_ms:.4f} "
        f"sdpa {lib_ms:.4f}; bound {b_[0]:.4f} ({b_[1]})")
    _record("flash_attention", err)
    RESULTS["flash_attention"].setdefault("also_timed", []).append(
        {"at": f"B={B} S={S} causal Hq={Hq} Hkv={Hkv} D={D}", "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_[0], "library_ms": lib_ms})
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def check_decode_g7() -> None:
    """Decode at Qwen2.5-VL-7B's group (Hq 28 over Hkv 4: G 7, D 128), 1000
    of 4096 live rows over 28 layers: flash_decode_at_layer on the 5-D
    cache and both int8 variants on its quantized rows, against their plain
    versions (TOL_DECODE_REL / TOL_Q8_REL of max |ref|), a repeat bit-equal;
    the bf16 kernel's device time over the 28 layers in turn."""
    from aha_tpu_torch.ops import attention
    from aha_tpu_torch.ops import flash_attention as fa

    L, S, Hq, Hkv, D, valid = 28, 4096, 28, 4, 128, 1000
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = _planted_decode_cache(g, L, S, Hq, Hkv, D, valid)
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    rel, err = 0.0, 0.0
    kq, ks = attention.quantize_kv_rows(k.reshape(L, 1, S, Hkv, D))
    vq, vs = attention.quantize_kv_rows(v.reshape(L, 1, S, Hkv, D))
    kq, vq = kq.reshape(L, 1, S, Hkv * D), vq.reshape(L, 1, S, Hkv * D)
    rel8 = {False: 0.0, True: 0.0}
    for li in (0, L - 1):
        lt = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = fa.flash_decode_at_layer(q, k, v, lt, vl)
        again = fa.flash_decode_at_layer(q, k, v, lt, vl)
        ref = fa.flash_decode_at_layer_plain(q.float(), k.float(), v.float(),
                                             lt, vl)
        e, r = _rel_err(got, ref)
        err, rel = max(err, e), max(rel, r)
        require(torch.equal(got, again), "G 7 decode: a repeat differs")
        ref8 = fa.flash_decode_at_layer_q8_plain(q.float(), kq, vq, ks, vs,
                                                 lt, vl)
        for mxu in (False, True):
            got8 = fa.flash_decode_at_layer_q8(q, kq, vq, ks, vs, lt, vl,
                                               mxu=mxu)
            rel8[mxu] = max(rel8[mxu], _rel_err(got8, ref8)[1])
    require(rel <= TOL_DECODE_REL, f"G 7 decode: {rel} of max |ref| (tol "
            f"{TOL_DECODE_REL})")
    for mxu, r in rel8.items():
        require(r <= TOL_Q8_REL[mxu], f"G 7 int8 decode mxu={mxu}: {r} of "
                f"max |ref| (tol {TOL_Q8_REL[mxu]})")
    layer = _layer_cycle(L)
    ms = device_ms(lambda: fa.flash_decode_at_layer(q, k, v, layer(), vl),
                   iters=56)
    b = bound(valid * Hkv * D * 2 * 2 + 2 * Hq * D * 2, 4 * Hq * valid * D)
    log(f"[kernels] decode G 7 (Qwen2.5-VL-7B: L={L} S={S} valid={valid} "
        f"Hq={Hq} Hkv={Hkv} D={D}): {rel:.3e} of max |ref| (tol "
        f"{TOL_DECODE_REL}), repeat bit-equal; int8 cast {rel8[False]:.3e}, "
        f"all-int8 {rel8[True]:.3e}; device ms/call {ms:.4f}; bound "
        f"{b[0]:.4f} ({b[1]})")
    _record("flash_decode_at_layer", err)
    RESULTS["flash_decode_at_layer"]["g7"] = dict(
        ms=ms, rel_err=rel, bound_ms=b[0], int8_rel_err=rel8[False],
        int8_mxu_rel_err=rel8[True],
        shape=f"L={L} S={S} valid={valid} Hq={Hq} Hkv={Hkv} D={D}")
    del q, k, v, kq, vq, ks, vs
    torch.cuda.empty_cache()


def phase_kernels() -> None:
    check_stack(1000, 1, "bf16", timed=False)
    check_stack(1000, 28, "bf16", timed=True)
    check_stack(2047, 28, "bf16", timed=False)
    check_decode(2048, 1000, timed=True)
    check_decode(4096, 4000, timed=False)
    check_head()
    check_head(4096, "k4096")       # Qwen3-VL-8B's untied head, (w)'s decode
    check_prefill(256, True, timed=False)
    check_prefill(192, False, timed=False)
    check_prefill(2048, True, timed=True, record=True)
    check_prefill(512, True, timed=True, Hkv=2)     # (n1)'s prompt bucket
    check_prefill(2048, True, timed=True, Hkv=2)    # (n2)'s
    check_prefill(4096, True, timed=True)
    check_q8(2048, 1000, timed=True)
    check_q8(16384, 16000, timed=False)
    check_decode(16384, 16000, timed=False)
    check_batched(timed=True)
    check_quant_matmul("q8")
    check_quant_matmul("q4")
    check_quant_swiglu()
    check_quant_heads()
    for grids in STACK_GRIDS:
        check_stack(0, 1, grids, timed=False)
        check_stack(1000, 1, grids, timed=False)
    check_stack(1000, 28, "q8", timed=True)
    check_stack(1000, 28, "q4", timed=True)
    check_stack(2047, 28, "gguf", timed=True)
    check_segmented()
    check_segmented_d72()
    check_segmented_page()
    check_segmented_fun_asr()
    check_stacked_decode()
    check_ernie_decode()
    check_decode_g7()
    for key in SLOT_DECODE_SHAPES:
        check_slots_decode(key)
    check_prefill_batched()
    # row 1 at LFM2-1.2B's 32/8 heads of 64: (u1)'s 512 bucket and 2048
    check_prefill(512, True, timed=True, Hkv=8, Hq=32, D=64)
    check_prefill(2048, True, timed=True, Hkv=8, Hq=32, D=64)
    # row 1 at Qwen3-VL-8B's 32/8 heads of 128: (w1)'s 2048 bucket
    check_prefill(2048, True, timed=True, Hkv=8, Hq=32)
    # row 1 at ERNIE-4.5's 16/2 heads of 128: (y1)'s page prompt, 4096
    check_prefill(4096, True, timed=True, Hkv=2)
    check_dsocr_attention()
    check_decode_f32()
    check_fused_layer()
    torch.cuda.synchronize()


# -- 3b. the H100 design studies ----------------------------------------------


def phase_studies() -> None:
    """The studies' main path: each study's `main(["--quick"])` (the
    entry point of `python -m aha_tpu_torch.studies.<name> --quick`) at the
    scripts' full geometry — K 1024, N 151936; 28 layers of Qwen3-0.6B
    widths at M = 8 — with the counts zeroed before and read after (path
    "studies").  Each main holds every kernel to its plain version (raising
    past TOL_STUDY) and times it, its plain version and its library
    yardstick by profiler device time; those readings are the JSON line's."""
    from aha_tpu_torch.studies import exp_fused_layer, exp_gemv, exp_int4

    wr = zero_counts()
    results = {}
    for mod in (exp_gemv, exp_int4, exp_fused_layer):
        results.update(mod.main(["--quick"]))
    read_counts(wr, "studies", STUDY_KERNELS)
    for name in STUDY_KERNELS:
        r = results[name]
        if TOL_STUDY[name] == 0.0:
            require(r["max_abs_err"] == 0.0, f"{name} is not bit-equal")
        _record(name, r["max_abs_err"], r["ms"], r["plain_ms"],
                (r["bound_ms"], r["bound_by"]), r["library_ms"], r["library"],
                f"{r['variant'] or 'the one variant'} at the script's "
                f"geometry")
        RESULTS[name]["gbps"] = r["gbps"]
        RESULTS[name]["tol"] = TOL_STUDY[name]
        if r.get("library_bf16_ms") is not None:
            # gemv_m8's library call writes f32 as the kernel does; the
            # bf16-out call it replaced as the yardstick stays beside it
            RESULTS[name]["library_bf16_ms"] = r["library_bf16_ms"]
    torch.cuda.empty_cache()


# -- 4. engine main path ------------------------------------------------------


def _prompt(rng, n: int, vocab: int) -> list[int]:
    return [int(x) for x in rng.integers(0, vocab, n)]


def teacher_forced_hidden(model, params, ids: list[int], forced: list[int],
                          device, window: int | None = None
                          ) -> tuple[torch.Tensor, list[int]]:
    """Prefill `ids`, then feed `forced` one token per step (with `window`,
    through the fused decode stack); returns the stacked final hidden
    states (1 + len(forced), H) in f32 and the greedy token at each
    position."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import bucket_for

    cache = model.init_cache(1, 512, params["embed"]["w"].dtype)
    x = torch.zeros((1, bucket_for(len(ids))), dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    hs = [model.backbone(params, x.to(device), cache)[0, len(ids) - 1]]
    kv.advance(cache, len(ids))
    for t in forced:
        tok = torch.tensor([[t]], device=device)
        hs.append(model.backbone(params, tok, cache, window=window)[0, 0])
        kv.advance(cache, 1)
    hid = torch.stack(hs)
    greedy = [int(model.greedy_token(params, h)) for h in hs]
    return hid.float().cpu(), greedy


def _requests(reqs, **kw):
    """`run` for eager_twin: each (ids, cfg, max_tokens) of `reqs` through
    the engine's generate_tokens in turn."""
    def run(eng):
        outs, timings = [], []
        for ids, cfg, n in reqs:
            outs.append(eng.generate_tokens(ids, cfg, max_tokens=n, **kw))
            timings.append(eng.last_timing)
        return outs, timings

    return run


def phase_engine(cfg, device: str = "cuda") -> dict:
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen3 import Qwen3Model

    V = cfg.vocab_size
    model = Qwen3Model(cfg, max_rope_len=8192, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_random(gen, dtype=torch.bfloat16)
    _sync(device)
    n_params = (params["embed"]["w"].numel()
                + sum(t.numel() for t in _leaves(params["layers"]))
                + params["norm"]["w"].numel())
    log(f"[engine] Qwen3 L={cfg.num_hidden_layers} H="
        f"{cfg.hidden_size} V={V} tied: {n_params / 1e6:.1f} M bf16 params "
        f"seeded on the card in {time.perf_counter() - t0:.1f} s (set-up)")
    rng = np.random.default_rng(0)
    greedy = SamplingConfig()
    sampled = SamplingConfig(temperature=0.7, top_k=20, top_p=0.9, seed=1234)

    # warm-up of the same shapes on a cache-less engine (cuBLAS heuristics,
    # allocator), not counted
    warm = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    warm.generate_tokens(_prompt(rng, 300, V), greedy, max_tokens=32)
    warm.generate_tokens(_prompt(rng, 20, V), sampled, max_tokens=16)
    del warm

    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     prefix_cache_entries=4)
    a_ids, b_ids = _prompt(rng, 20, V), _prompt(rng, 300, V)
    c_ids = b_ids + _prompt(rng, 40, V)
    e_ids = _prompt(rng, 2100, V)
    wr = zero_counts()
    _sync(device)
    out_a = eng.generate_tokens(a_ids, greedy, max_tokens=64)
    out_b = eng.generate_tokens(b_ids, greedy, max_tokens=128)
    tb = eng.last_timing
    out_c = eng.generate_tokens(c_ids, greedy, max_tokens=32)
    stored = len(eng._prefix_entries)
    out_d = eng.generate_tokens(a_ids, sampled, max_tokens=32)
    n_fused = wr["fused_decode_stack"].launches
    out_e = eng.generate_tokens(e_ids, greedy, max_tokens=32)
    te = eng.last_timing
    _sync(device)
    engine_counts = read_counts(wr, "engine", (
        "flash_decode_at_layer_flat", "head_argmax", "flash_attention",
        "fused_decode_stack"))
    # (a)-(d) run 4 + 8 + 2 + 2 decode blocks of 16 steps, each step one
    # fused launch; (e), past 2048 rows, none
    require(n_fused == 16 * (4 + 8 + 2 + 2)
            and wr["fused_decode_stack"].launches == n_fused,
            f"fused stack launches {n_fused}, "
            f"{wr['fused_decode_stack'].launches}")
    for name, out, n in (("a", out_a, 64), ("b", out_b, 128),
                         ("c", out_c, 32), ("d", out_d, 32),
                         ("e", out_e, 32)):
        require(len(out) == n and all(0 <= t < V for t in out),
                f"request {name}: {len(out)} tokens, range bad")
    require(stored == 2,
            f"prefix store holds {stored} entries, expected 2")
    require(len(set(out_d)) > 1,
            f"sampled request drew one token: {out_d}")
    log(f"[engine] (a) 20-token prompt, bucket 32 plain prefill: 64 greedy")
    log(f"[engine] (b) 300-token prompt, bucket 512 kernel prefill: 128 "
        f"greedy")
    log(f"[engine] (c) (b)+40 tokens, prefix restore + suffix prefill: 32 "
        f"greedy; store holds {stored}")
    log(f"[engine] (d) sampled T=0.7 top_k=20 top_p=0.9: 32 tokens, "
        f"{len(set(out_d))} distinct")
    log(f"[engine] (e) 2100-token prompt, bucket 4096 kernel prefill: 32 "
        f"greedy, decode past 2048 rows on the per-op chain")
    card = card_line() if device == "cuda" else "cpu"

    def rate(t):
        return (t.completion_tokens - 1) / t.completion_secs

    log(f"[engine] (b) prefill {tb.prompt_secs * 1e3:.2f} ms for 300 tokens "
        f"(bucket 512, incl. first token read), decode {rate(tb):.1f} tok/s "
        f"at batch 1 (fused stack) | {card}")
    log(f"[engine] (e) prefill {te.prompt_secs * 1e3:.2f} ms for 2100 tokens "
        f"(bucket 4096), decode {rate(te):.1f} tok/s at batch 1 (per-op "
        f"chain, 2100+ rows) | {card}")
    reqs = ((a_ids, greedy, 64), (b_ids, greedy, 128), (c_ids, greedy, 32),
            (a_ids, sampled, 32), (e_ids, greedy, 32))
    eager_twin("(a)-(e)", eng, lambda: TextEngine(
        model, params, eos_token_ids=[], max_seq_len=8192,
        prefix_cache_entries=4, cuda_graphs=False), _requests(reqs),
        [out_a, out_b, out_c, out_d, out_e], engine_counts, device,
        groups={"(a)-(c) greedy, fused stack": (0, 1, 2),
                "(d) sampled, fused stack": (3,),
                "(e) greedy past 2048 rows, per-op chain": (4,)})
    # (b) once more with the fused stack switched off, outside the counted
    # main path: the per-op chain on the same request, graphed and eager
    os.environ["AHA_FUSED_LAYER"] = "0"
    try:
        plain_eng = TextEngine(model, params, eos_token_ids=[],
                               max_seq_len=8192)
        wr = zero_counts()
        out_b0 = plain_eng.generate_tokens(b_ids, greedy, max_tokens=128)
        _sync(device)
        tb0 = plain_eng.last_timing
        eager_twin("(b) per-op chain", plain_eng, lambda: TextEngine(
            model, params, eos_token_ids=[], max_seq_len=8192,
            cuda_graphs=False), _requests(reqs[1:2]), [out_b0],
            {name: fn.launches for name, fn in wr.items()}, device)
    finally:
        del os.environ["AHA_FUSED_LAYER"]
    same = next((i for i, (x, y) in enumerate(zip(out_b, out_b0)) if x != y),
                len(out_b))
    log(f"[engine] (b) per-op chain: decode {rate(tb0):.1f} tok/s at batch 1 "
        f"(graphs captured in this request) | {card}; greedy streams equal "
        f"to the fused stack's for the first {same}/128 tokens")

    # 8 teacher-forced steps of (b) through each decode path on the card vs
    # the plain path (float32 on the CPU: there every wrapper runs its
    # plain version and the fused gate, bf16 only, stays shut)
    forced = out_b[:8]
    cpu_model, cpu_params = _f32_cpu(model, params)
    hp, gp = teacher_forced_hidden(cpu_model, cpu_params, b_ids, forced,
                                   "cpu")
    for path, window in (("fused stack", 512), ("per-op chain", None)):
        hk, gk = teacher_forced_hidden(model, eng.params, b_ids, forced,
                                       device, window)
        rel = ((hk - hp).abs().max() / hp.abs().max()).item()
        rel_dec = ((hk[1:] - hp[1:]).abs().max() / hp.abs().max()).item()
        agree = sum(x == y for x, y in zip(gk, gp))
        log(f"[engine] teacher-forced (b), {path}, 9 positions: hidden max "
            f"err {rel:.3e} of max |ref| ({rel_dec:.3e} over the 8 decode "
            f"steps; tol {TOL_HIDDEN_REL}); greedy agreement "
            f"{agree}/{len(gk)}")
        require(rel <= TOL_HIDDEN_REL,
                f"{path} hidden off by {rel}")
    return {"model": model, "params": params}


# -- 4b. speculative decoding -------------------------------------------------

#: the (o)-(r) prompts: a 48-token cycle of seeded ids (drafts the seeded
#: model's greedy targets accept) and (p)'s bucket-end prompt
SPEC_CYCLE = 48
SPEC_DRAFTS = 8
# where a speculative stream parts from plain greedy decoding of the same
# prefix on the card, the two candidates' logits at that position,
# recomputed in f32 on the CPU through the plain versions, must lie within
# this share of the row's max |logit|: the verify pass (per-op chain over
# G1 rows, plain attention over the bucket with bf16 probabilities) and
# plain decode (fused stack, head_argmax) round differently, which
# separates a near-tie of the seeded model's flat logits (max |logit|
# ≈ 2.9).  Measured on an H100 over (o)-(r): 15 partings in 468 tokens,
# gaps 1.3e-4 to 7.4e-3 of max |logit| (the bound 2.7x the largest)
TOL_SPEC_TIE_REL = 2e-2


def _cyclic(rng, n: int, vocab: int) -> list[int]:
    cycle = _prompt(rng, SPEC_CYCLE, vocab)
    return [cycle[i % SPEC_CYCLE] for i in range(n)]


def _f32_cpu(model, params) -> tuple:
    """The model's plain path on the CPU in float32 (the grids' integer
    tensors kept: a CPU quantized linear dequantizes exactly): the same
    class (Qwen3Model, LlamaModel) at the same config."""
    cpu_params = _tree_to(params, "cpu", torch.float32)
    if params["lm_head"].get("w") is params["embed"]["w"]:    # tied
        cpu_params["lm_head"] = {"w": cpu_params["embed"]["w"]}
    return type(model)(model.config, max_rope_len=8192, device="cpu"), \
        cpu_params


def _f32_hidden(m, p, ids: list[int]) -> torch.Tensor:
    """The f32 CPU model's final hidden over `ids` from position 0: its
    cache-free forward where it has one, else a prefill into a fresh
    cache."""
    x = torch.tensor([ids])
    if hasattr(m, "forward_hidden"):
        return m.forward_hidden(p, x)
    return m.backbone(p, x, m.init_cache(1, len(ids), torch.float32))


def _walk_ties(what: str, plain, got: list[int], ids: list[int], model,
               params, cpu: dict, tag: str = "spec",
               tol: float = TOL_SPEC_TIE_REL) -> dict:
    """Every token of `got` equal to what the plain engine decodes
    greedily from the same prefix (`ids` + got[:i]), or, where they part,
    the two candidates' logits within `tol` of max |logit| in f32 on the
    CPU: the plain engine is re-run from each parting with the other
    path's token taken, and one f32 forward over the stream reads the
    logits of every parting.  `cpu` caches the f32 model; `tag` heads the
    log lines."""
    from aha_tpu_torch.core.sampling import SamplingConfig

    parts, i = [], 0
    while i < len(got):
        want = plain.generate_tokens(ids + got[:i], SamplingConfig(),
                                     max_tokens=len(got) - i)
        require(len(want) == len(got) - i, f"{what}: the plain engine "
                f"gave {len(want)} tokens from {i}, not {len(got) - i}")
        j = next((k for k, (x, y) in enumerate(zip(got[i:], want))
                  if x != y), None)
        if j is None:
            break
        parts.append((i + j, want[j]))
        i += j + 1
    if not parts:
        log(f"[{tag}] {what}: equal to plain greedy decoding ({len(got)} "
            f"tokens)")
        return {"parts": []}
    if not cpu:
        cpu["model"], cpu["params"] = _f32_cpu(model, params)
    m, p = cpu["model"], cpu["params"]
    rows = [len(ids) - 1 + k for k, _ in parts]
    with torch.no_grad():
        h = _f32_hidden(m, p, ids + got[:parts[-1][0]])
        logits = m.logits(p, h[:, rows]).float()[0]
    gaps = []
    for r, (k, w) in enumerate(parts):
        top = logits[r].abs().max().item()
        gaps.append(abs(logits[r, got[k]] - logits[r, w]).item() / top)
    log(f"[{tag}] {what}: parts from plain greedy decoding of the same "
        f"prefix at {len(parts)} of {len(got)} tokens {[k for k, _ in parts]}"
        f"; the candidates' f32 logit gaps {[f'{x:.2e}' for x in gaps]} of "
        f"max |logit| (tie bound {tol})")
    require(max(gaps) <= tol, f"{what}: parts at "
            f"{parts[gaps.index(max(gaps))][0]} where the f32 logits "
            f"differ by {max(gaps)} of max |logit|")
    return {"parts": [k for k, _ in parts], "max_gap_rel": max(gaps)}


def _spec_request(eng, ids, n):
    """run for eager_twin: one greedy request; its tokens with every
    round's accepted count."""
    from aha_tpu_torch.core.sampling import SamplingConfig

    def run(e):
        out = e.generate_tokens(ids, SamplingConfig(), max_tokens=n)
        return [(out, list(e.last_spec_a))], [e.last_timing]

    return run


def _per_token_ms(t) -> float:
    return t.completion_secs / max(t.completion_tokens - 1, 1) * 1e3


def _spec_path(label: str, model, params, ids: list[int], n: int,
               must: tuple[str, ...], device: str, cpu: dict,
               max_seq_len: int = 8192, same_as: list[int] | None = None,
               **kw) -> dict:
    """One speculative request on a graphed engine (counts zeroed before,
    read after: path `spec-<label>`), then again with its graphs captured
    (the same tokens; its ms per emitted token).  With `same_as` the
    stream must equal that one; else it is walked against the plain
    graphed engine (`_walk_ties`), and its eager twin must give the same
    tokens, accepted counts and launches."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    def engine(spec, graphs=True):
        return TextEngine(model, params, eos_token_ids=[],
                          max_seq_len=max_seq_len, spec_tokens=spec,
                          cuda_graphs=graphs, **kw)

    eng = engine(SPEC_DRAFTS)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=n)
    _sync(device)
    a = list(eng.last_spec_a)
    counts = read_counts(wr, f"spec-{label}", must)
    require(out and a, f"({label}): {len(out)} tokens, {len(a)} rounds")
    stats = _graph_stats(eng, device)
    again = eng.generate_tokens(ids, SamplingConfig(), max_tokens=n)
    require(again == out and eng.last_spec_a == a, f"({label}): a repeat "
            f"differs")
    t = eng.last_timing
    plain = engine(0)
    plain.generate_tokens(ids, SamplingConfig(), max_tokens=n)   # captures
    want = plain.generate_tokens(ids, SamplingConfig(), max_tokens=n)
    t_plain = plain.last_timing
    require(len(out) == len(want), f"({label}): {len(out)} tokens, plain "
            f"{len(want)}")
    if same_as is not None:
        require(out == same_as, f"({label}): the stream differs from the "
                f"drafted one")
        tie = {}
    else:
        tie = _walk_ties(f"({label})", plain, out, ids, model, params, cpu)
        eager_twin(f"({label}) spec", eng, lambda: engine(SPEC_DRAFTS,
                                                          False),
                   _spec_request(eng, ids, n), [(out, a)], counts, device)
    card = card_line() if device == "cuda" else "cpu"
    hist = {k: a.count(k) for k in sorted(set(a))}
    log(f"[spec] ({label}) {len(ids)}-token prompt, {len(out)} greedy "
        f"tokens (max_tokens {n}): {_per_token_ms(t):.3f} ms per emitted "
        f"token graphed, plain graphed engine {_per_token_ms(t_plain):.3f};"
        f" {len(a)} rounds, mean a {np.mean(a):.2f}, a histogram {hist}; "
        f"{stats['graphs']} graphs captured in {stats['capture_s']:.2f} s "
        f"| {card}")
    SPEC_READINGS.append({
        "path": label, "tokens": len(out), "ms_per_token":
        _per_token_ms(t), "plain_ms_per_token": _per_token_ms(t_plain),
        "rounds": len(a), "mean_a": float(np.mean(a)), "a_hist": hist,
        **stats, **tie})
    return {"out": out, "a_hist": hist}


#: per speculative path: ms per emitted token (graphs captured) beside the
#: plain graphed engine's, rounds, accepted counts, graphs, and where the
#: stream parts from plain greedy decoding at a near-tie (printed as one
#: JSON line before the kernels line)
SPEC_READINGS: list[dict] = []


def phase_spec(model, params, device: str = "cuda") -> None:
    """(o)-(r): prompt-lookup speculative decoding (8 drafts a round, 8
    rounds a dispatch) through TextEngine at Qwen3-0.6B's widths: (o) bf16,
    a 300-token cyclic prompt, 192 greedy tokens, and the same with
    spec_no_drafts; (p) a 470-token prompt in the 512-row bucket with
    max_tokens past it, drafted and draftless, so the host guard drops to
    single rounds and hands the stream to the decode blocks; (q) the int8
    cache and (r) the q4 pack (its verify pass on the quantized matmul and
    MLP kernels at M = 9), 96 tokens each.  Every token held to the plain
    graphed engine's greedy decoding of the same prefix (or parted from it
    at a near-tie), graphed against eager (tokens, a's, launches); (o)'s
    draftless stream equal to the drafted one."""
    from aha_tpu_torch.models.qwen3 import pack_params

    V = model.config.vocab_size
    rng = np.random.default_rng(500)
    cpu: dict = {}
    ids = _cyclic(rng, 300, V)
    o = _spec_path("o", model, params, ids, 192, ("flash_attention",),
                   device, cpu)
    o0 = _spec_path("o no-drafts", model, params, ids, 192,
                    ("flash_attention",), device, cpu, same_as=o["out"],
                    spec_no_drafts=True)
    require(set(o0["a_hist"]) == {0}, f"no-drafts rounds accepted "
            f"{o0['a_hist']}")
    log("[spec] (o) no-drafts: every round a = 0, stream equal to the "
        "drafted one")
    p_ids = _cyclic(rng, 470, V)
    # the draftless rounds stop at pos 504 and the decode blocks take the
    # last 7 tokens: the tail's fused stack and head launch
    _spec_path("p", model, params, p_ids, 1024, ("flash_attention",),
               device, cpu, max_seq_len=512)
    _spec_path("p no-drafts", model, params, p_ids, 1024, (
        "flash_attention", "fused_decode_stack", "head_argmax"), device,
        cpu, max_seq_len=512, spec_no_drafts=True)
    _spec_path("q", model, params, ids, 96, ("flash_attention",), device,
               cpu, cache_dtype=torch.int8)
    packed = pack_params(params, "q4")
    _spec_path("r", model, packed, ids, 96, (
        "flash_attention", "quant_matmul_q4", "quant_swiglu"), device, {})
    del packed
    if device == "cuda":
        torch.cuda.empty_cache()


# -- 5. continuous batching and the int8 cache --------------------------------

#: the request of the (f)/(g) mix that samples (a 420-token prompt)
SAMPLED = 5

def _block_reading(eng, device: str) -> tuple[dict, dict]:
    """One `decode_block` dispatch of every slot, in each mode, on an
    engine whose scheduler has stopped (slots at 1000 live rows): the
    launches of one block by mode, and ms per step over 8 blocks."""
    counts, ms = {}, {}
    blk = eng.decode_block
    with torch.no_grad():
        for mode in ("greedy", "general"):
            eng._refresh_step_inputs([True] * eng.slots)
            eng._mode = mode
            eng._cache["pos"].fill_(1000)
            wr = zero_counts()
            eng._decode_n(blk)
            _sync(device)
            counts[mode] = {name: fn.launches for name, fn in wr.items()}
            t0 = time.perf_counter()
            for _ in range(8):
                eng._decode_n(blk)
            _sync(device)
            ms[mode] = (time.perf_counter() - t0) * 1e3 / (8 * blk)
    return counts, ms


def _batch_path(model, params, device: str, cache_dtype, name: str,
                must: tuple[str, ...], slots: int = 8,
                prefix_cache_entries: int = 0) -> dict:
    """(f)/(g): a BatchEngine of `slots` slots, max_seq_len 4096, the 12
    requests of BATCH_PROMPTS, 64 tokens each, from threads at once; one
    of them sampled (temperature, top-k, top-p, repeat penalty), so the
    steps it shares run the batched sampler with per-slot generators.
    Then the same through an engine built with cuda_graphs=False: every
    request's tokens equal; one block's launches in each mode equal; and
    each kernel's count over the run, less its launches a block times
    the blocks dispatched (which the scheduler's timing decides), equal.
    Returns the graphed run's launches, one block's launches, the block's
    steps and the steps dispatched."""
    from aha_tpu_torch.core.batch_engine import BatchEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.utils.profile_decode import (BATCH_PROMPTS,
                                                    drive_concurrent)

    V = model.config.vocab_size
    rng = np.random.default_rng(len(name))
    greedy = SamplingConfig()
    sampled = SamplingConfig(temperature=0.7, top_k=20, top_p=0.9,
                             repeat_penalty=1.1, seed=1234)
    cfgs = [greedy] * len(BATCH_PROMPTS)
    cfgs[SAMPLED] = sampled
    warm = [_prompt(rng, 40, V), _prompt(rng, 600, V)]
    prompts = [_prompt(rng, n, V) for n in BATCH_PROMPTS]
    runs = {}
    for graphed in (True, False):
        eng = BatchEngine(model, params, eos_token_ids=[], slots=slots,
                          cache_dtype=cache_dtype, max_seq_len=4096,
                          cuda_graphs=graphed,
                          prefix_cache_entries=prefix_cache_entries)
        try:
            # warm-up of the step and prefill shapes, not counted
            drive_concurrent(eng, warm, [greedy, sampled], 8)
            wr = zero_counts()
            s0 = eng.decode_steps
            _sync(device)
            outs, ttft, wall, peak = drive_concurrent(eng, prompts, cfgs, 64,
                                                      monitor=True)
            _sync(device)
            launches = (read_counts(wr, name, must) if graphed else
                        {n: fn.launches for n, fn in wr.items()})
            steps = eng.decode_steps - s0
        finally:
            eng.shutdown()
        block, ms = _block_reading(eng, device)
        runs[graphed] = dict(outs=outs, ttft=ttft, wall=wall, peak=peak,
                             launches=launches, steps=steps, block=block,
                             ms=ms, blk=eng.decode_block,
                             graphs=_graph_stats(eng, device)
                             if graphed else None)
    g, e = runs[True], runs[False]
    outs, ttft, wall, peak, launches = (g[k] for k in (
        "outs", "ttft", "wall", "peak", "launches"))
    for i, out in enumerate(outs):
        require(out is not None and len(out) == 64
                and all(0 <= t < V for t in out),
                f"{name} request {i}: {out and len(out)} tokens")
    require(peak == slots, f"{name}: peak occupied slots {peak} of {slots}")
    require(launches["fused_decode_stack"] == 0
            and launches["fused_decode_stack_q8"] == 0,
            f"{name}: a fused stack ran on a batched path")
    n_distinct = len(set(outs[SAMPLED]))
    require(n_distinct > 1,
            f"{name}: the sampled request drew one token: {outs[SAMPLED]}")
    require(e["outs"] == outs, f"{name}: graphed tokens differ from eager")
    require(g["block"] == e["block"], f"{name}: a block's launches graphed "
            f"vs eager differ: {_diff(g['block'], e['block'])}")
    require(g["block"]["greedy"] == g["block"]["general"],
            f"{name}: a greedy and a general block launch other kernels")
    blk = g["blk"]
    per_block = g["block"]["general"]
    for k in launches:
        # the run's launches outside its decode blocks: the prefills'
        rest = [r["launches"][k] * blk - r["steps"] * per_block[k]
                for r in (g, e)]
        require(rest[0] == rest[1], f"{name}: {k} launches besides the "
                f"decode blocks differ graphed vs eager: "
                f"{g['launches'][k]} in {g['steps']} steps, "
                f"{e['launches'][k]} in {e['steps']} steps")
    card = card_line() if device == "cuda" else "cpu"
    log(f"[{name}] {len(prompts)} requests of {len(prompts[0])}-"
        f"{len(prompts[-1])} prompt tokens, 64 tokens each (11 greedy, 1 "
        f"sampled T=0.7 top_k=20 top_p=0.9 penalty 1.1: {n_distinct} "
        f"distinct), {slots} slots "
        f"({str(cache_dtype).replace('torch.', '')} cache): "
        f"all finished, peak {peak} slots busy; aggregate "
        f"{len(prompts) * 64 / wall:.1f} tok/s over {wall:.2f} s; time to "
        f"first token mean {np.mean(ttft) * 1e3:.1f} ms, max "
        f"{max(ttft) * 1e3:.1f} ms | {card}")
    log(f"[graphs] {name}: tokens equal to the eager engine's, a block's "
        f"launches equal in both modes, and the launches besides the "
        f"blocks ({g['steps']} and {e['steps']} steps dispatched); "
        f"{g['graphs']['graphs']} graphs captured in "
        f"{g['graphs']['capture_s']:.2f} s; eager run aggregate "
        f"{len(prompts) * 64 / e['wall']:.1f} tok/s | {card}")
    for mode in ("greedy", "general"):
        GRAPH_READINGS.append({
            "path": f"{name} {mode} block", **g["graphs"],
            "ms_per_step_graphed": g["ms"][mode],
            "ms_per_step_eager": e["ms"][mode]})
        log(f"[graphs] {name}, {mode} block of {blk} steps, {slots} slots at "
            f"1000 rows: {g['ms'][mode]:.3f} ms/step graphed, "
            f"{e['ms'][mode]:.3f} eager | {card}")
    return {"launches": launches, "block": per_block, "blk": blk,
            "steps": g["steps"], "prompts": BATCH_PROMPTS}


def _int8_text_path(model, params, device: str) -> None:
    """(h): an int8 TextEngine, a 300-token prompt and 128 greedy tokens."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    V = model.config.vocab_size
    rng = np.random.default_rng(300)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     cache_dtype=torch.int8)
    eng.generate_tokens(_prompt(rng, 300, V), SamplingConfig(), 16)  # warm
    ids = _prompt(rng, 300, V)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=128)
    _sync(device)
    counts = read_counts(wr, "int8-text", ("flash_decode_at_layer_q8",))
    require(len(out) == 128 and all(0 <= t < V for t in out),
            f"int8 TextEngine: {len(out)} tokens")
    eager_twin("(h) int8 cache, per-op chain", eng, lambda: TextEngine(
        model, params, eos_token_ids=[], max_seq_len=8192,
        cache_dtype=torch.int8, cuda_graphs=False),
        _requests([(ids, SamplingConfig(), 128)]), [out], counts, device)
    t = eng.last_timing
    card = card_line() if device == "cuda" else "cpu"
    log(f"[int8-text] (h) 300-token prompt, int8 cache: 128 greedy tokens, "
        f"prefill {t.prompt_secs * 1e3:.2f} ms, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at "
        f"batch 1 (per-op chain) | {card}")


def teacher_forced_slots(model, params, prompts: list[list[int]],
                         forced: torch.Tensor, device, cache_dtype,
                         cache: dict | None = None):
    """Decode `forced` (B, n) one column per step through a per-slot cache
    of B slots; with no `cache`, first prefill each prompt at batch 1 into
    its slot (its rows, and a hybrid's rolling state whole).  Returns the
    (n, B, H) f32 hidden states on the CPU and the cache as it stood before
    the first step (on the CPU)."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import bucket_for

    B = len(prompts)
    if cache is None:
        cache = model.init_cache(B, 1024, cache_dtype, per_slot_pos=True)
        for b, ids in enumerate(prompts):
            small = model.init_cache(1, bucket_for(len(ids)), cache_dtype)
            x = torch.zeros((1, bucket_for(len(ids))), dtype=torch.int64)
            x[0, :len(ids)] = torch.tensor(ids)
            model.backbone(params, x.to(device), small, prompt_len=len(ids))
            for name in kv.ROW_KEYS:
                if name in small:
                    cache[name][:, b, :len(ids)] = small[name][:, 0, :len(ids)]
            for name in kv.STATE_KEYS:
                if name in small:
                    cache[name][:, b] = small[name][:, 0]
            cache["pos"][b] = len(ids)
    before = {k: v.to("cpu", copy=True) for k, v in cache.items()}
    hs = []
    for step in range(forced.shape[1]):
        tok = forced[:, step:step + 1].to(device)
        hs.append(model.backbone(params, tok, cache)[:, 0])
        kv.advance(cache, 1)
    return torch.stack(hs).float().cpu(), before


def phase_batch(model, params, device: str = "cuda") -> None:
    _batch_path(model, params, device, torch.bfloat16, "batch-bf16",
                ("flash_decode_at_layer_flat_batched",))
    _batch_path(model, params, device, torch.int8, "batch-int8",
                ("flash_decode_at_layer_q8_batched",))
    _int8_text_path(model, params, device)

    # (i) 8 teacher-forced steps of 4 slots on the card against the f32
    # plain path on the CPU, from the same cache contents
    _teacher_forced_4_slots(model, params, device,
                            (torch.bfloat16, torch.int8), "batch")


def _teacher_forced_4_slots(model, params, device: str, dtypes,
                            tag: str) -> None:
    """8 teacher-forced steps of 4 slots (prompts of 50, 120, 300 and 700
    tokens, each prefilled at batch 1 into its slot) through the per-slot
    decode on the card, against the same steps in f32 on the CPU through
    the plain versions from the same cache contents: hidden states within
    TOL_HIDDEN_REL of max |ref|, for each cache dtype."""
    V = model.config.vocab_size
    rng = np.random.default_rng(9)
    prompts = [_prompt(rng, n, V) for n in (50, 120, 300, 700)]
    forced = torch.tensor(rng.integers(0, V, (4, 8)))
    cpu_model, cpu_params = _f32_cpu(model, params)
    for dtype in dtypes:
        hk, before = teacher_forced_slots(model, params, prompts, forced,
                                          device, dtype)
        if dtype != torch.int8:
            before = {k: (v.float() if v.is_floating_point() else v)
                      for k, v in before.items()}
        hp, _ = teacher_forced_slots(cpu_model, cpu_params, prompts, forced,
                                     "cpu", None, cache=before)
        rel = ((hk - hp).abs().max() / hp.abs().max()).item()
        log(f"[{tag}] teacher-forced 4 slots x 8 steps, "
            f"{str(dtype).replace('torch.', '')} cache: hidden max err "
            f"{rel:.3e} of max |ref| (tol {TOL_HIDDEN_REL})")
        require(rel <= TOL_HIDDEN_REL,
                f"{tag}: batched {dtype} hidden off by {rel}")


# -- 6. GGUF-quantized paths ---------------------------------------------------

#: the GGUF file of (m): its depth, cut from Qwen3-0.6B's 28 layers (the
#: widths stay the published ones)
GGUF_LAYERS = 4


def _quant_text_path(model, params, grid: str, device: str) -> None:
    """(j)/(k): a TextEngine over the bf16 weights packed on one grid, the
    head too: a 20-token prompt (its 32-row prefill bucket runs the
    quant-matmul and fused-SwiGLU kernels) and 16 greedy tokens, then a
    300-token prompt and 128 greedy tokens; every decode step is one launch
    of the quantized fused stack.  Then the 300-token request once more on
    the per-op chain (AHA_FUSED_LAYER=0), outside the counted path."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    V = model.config.vocab_size
    rng = np.random.default_rng(400 + len(grid))
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    eng.generate_tokens(_prompt(rng, 300, V), SamplingConfig(), 16)  # warm
    short, ids = _prompt(rng, 20, V), _prompt(rng, 300, V)
    wr = zero_counts()
    _sync(device)
    out_s = eng.generate_tokens(short, SamplingConfig(), max_tokens=16)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=128)
    t = eng.last_timing
    _sync(device)
    mm = "quant_matmul_q4" if grid == "q4" else "quant_matmul"
    launches = read_counts(wr, f"{grid}-text",
                           (mm, "quant_swiglu", f"head_argmax_{grid}",
                            "fused_decode_stack_q8"))
    # 1 + 8 decode blocks of 16 steps, each step one fused launch
    require(launches["fused_decode_stack"] == 0
            and launches["fused_decode_stack_q8"] == 16 * 9,
            f"{grid} TextEngine: fused launches {launches}")
    require(len(out_s) == 16 and len(out) == 128
            and all(0 <= t < V for t in out_s + out),
            f"{grid} TextEngine: {len(out_s)} + {len(out)} tokens")
    label = {"q8": "(j)", "q4": "(k)"}[grid]
    reqs = [(short, SamplingConfig(), 16), (ids, SamplingConfig(), 128)]
    eager_twin(f"{label} {grid} fused stack", eng, lambda: TextEngine(
        model, params, eos_token_ids=[], max_seq_len=8192,
        cuda_graphs=False), _requests(reqs), [out_s, out], launches, device)
    os.environ["AHA_FUSED_LAYER"] = "0"
    try:
        plain_eng = TextEngine(model, params, eos_token_ids=[],
                               max_seq_len=8192)
        wr = zero_counts()
        out0 = plain_eng.generate_tokens(ids, SamplingConfig(),
                                         max_tokens=128)
        _sync(device)
        t0 = plain_eng.last_timing
        eager_twin(f"{label} {grid} per-op chain", plain_eng,
                   lambda: TextEngine(model, params, eos_token_ids=[],
                                      max_seq_len=8192, cuda_graphs=False),
                   _requests(reqs[1:]), [out0],
                   {name: fn.launches for name, fn in wr.items()}, device)
    finally:
        del os.environ["AHA_FUSED_LAYER"]
    same = next((i for i, (x, y) in enumerate(zip(out, out0)) if x != y),
                len(out))
    card = card_line() if device == "cuda" else "cpu"

    def rate(t):
        return (t.completion_tokens - 1) / t.completion_secs

    log(f"[{grid}-text] {label} 300-token prompt, {grid} weights and head: "
        f"128 greedy tokens, prefill {t.prompt_secs * 1e3:.2f} ms, decode "
        f"{rate(t):.1f} tok/s at batch 1 (quantized fused stack) | {card}")
    log(f"[{grid}-text] {label} per-op chain: decode {rate(t0):.1f} tok/s at "
        f"batch 1 (graphs captured in this request) | {card}; greedy streams "
        f"equal to the fused stack's for the first {same}/128 tokens")


def _write_gguf_model(path: str, cfg, n_layers: int, seed: int) -> None:
    """A Qwen3 GGUF at cfg's widths and n_layers, seeded numpy weights
    (0.02 scale, unit norms), written with the port's writer: token_embd
    Q8_0 (tied, so the head is quantized), attention and ffn_gate/up Q4_K,
    ffn_down Q6_K in every layer."""
    from aha_tpu_torch.io import gguf as G

    rng = np.random.default_rng(seed)
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    NQ, NKV = cfg.num_attention_heads * D, cfg.num_key_value_heads * D

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def ones(n):
        return (np.ones(n, np.float32), G.GGML_F32)

    tensors = {"token_embd.weight": (w(cfg.vocab_size, H), G.GGML_Q8_0),
               "output_norm.weight": ones(H)}
    for i in range(n_layers):
        b = f"blk.{i}."
        tensors.update({
            b + "attn_norm.weight": ones(H), b + "ffn_norm.weight": ones(H),
            b + "attn_q_norm.weight": ones(D),
            b + "attn_k_norm.weight": ones(D),
            b + "attn_q.weight": (w(NQ, H), G.GGML_Q4_K),
            b + "attn_k.weight": (w(NKV, H), G.GGML_Q4_K),
            b + "attn_v.weight": (w(NKV, H), G.GGML_Q4_K),
            b + "attn_output.weight": (w(H, NQ), G.GGML_Q4_K),
            b + "ffn_gate.weight": (w(I, H), G.GGML_Q4_K),
            b + "ffn_up.weight": (w(I, H), G.GGML_Q4_K),
            b + "ffn_down.weight": (w(H, I), G.GGML_Q6_K),
        })
    G.write_gguf(path, {
        "general.architecture": "qwen3",
        "qwen3.block_count": n_layers,
        "qwen3.embedding_length": H,
        "qwen3.feed_forward_length": I,
        "qwen3.attention.head_count": cfg.num_attention_heads,
        "qwen3.attention.head_count_kv": cfg.num_key_value_heads,
        "qwen3.attention.key_length": D,
        "qwen3.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
        "qwen3.rope.freq_base": cfg.rope_theta,
        "qwen3.context_length": cfg.max_position_embeddings,
    }, tensors)


def _zero_scales(tree):
    if isinstance(tree, dict):
        return {k: (torch.zeros_like(v) if k in ("st", "s4")
                    else _zero_scales(v)) for k, v in tree.items()}
    return tree


@contextlib.contextmanager
def card_routes_on_cpu():
    """On the CPU, quantized linears of ≤ MAX_KERNEL_M rows and the fused
    quantized MLP go through the kernels' plain versions (activation
    quantization), as they go through the kernels on the card, instead of
    the dequantize path the CPU takes otherwise."""
    from aha_tpu_torch.core import nn
    from aha_tpu_torch.ops import quant_matmul as qm

    linear, mlp = nn.quant_linear, nn.swiglu_mlp

    def quant_linear(p, x):
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[0] > qm.MAX_KERNEL_M:
            return linear(p, x)
        grid = "q4" if "q4" in p else "q8"
        fn = qm.quant_matmul_q4 if grid == "q4" else qm.quant_matmul
        y = fn(x2, *[p[k] for k in qm.GRID_KEYS[grid]])
        return (y + p["b"] if "b" in p else y).reshape(*x.shape[:-1], -1)

    def swiglu_mlp(p, x):
        if "gateup" in p and qm.swiglu_fusable(
                p["gateup"], p["down"], x.numel() // x.shape[-1]):
            return qm.quant_swiglu(p["gateup"], p["down"], x)
        return mlp(p, x)

    nn.quant_linear, nn.swiglu_mlp = quant_linear, swiglu_mlp
    try:
        yield
    finally:
        nn.quant_linear, nn.swiglu_mlp = linear, mlp


def _nudge_scales(tree):
    """Every grid scale times (1 + 2**-23): each quantized product moves by
    about one f32 rounding, the size of the card's own differences from the
    plain versions."""
    if isinstance(tree, dict):
        return {k: (v * (1 + 2 ** -23) if k in ("st", "s4")
                    else _nudge_scales(v)) for k, v in tree.items()}
    return tree


def _gguf_path(cfg, device: str) -> None:
    """(m): a GGUF Qwen3 written, loaded with the port's load_qwen3_gguf on
    the card, 32 greedy tokens (decode through the quantized fused stack);
    then 8 teacher-forced steps through each decode path against the same
    steps on the CPU through the kernels' plain versions (the witness) and
    through the exact dequantized path, and the same steps with every
    grid's scales zeroed, which must fail both bounds."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.io.gguf_models import load_qwen3_gguf
    from aha_tpu_torch.models.qwen3 import fuse_decode_params

    with tempfile.TemporaryDirectory(prefix="aha_torch_gguf_") as tmp:
        path = os.path.join(tmp, "qwen3-0.6b-width.gguf")
        t0 = time.perf_counter()
        _write_gguf_model(path, cfg, GGUF_LAYERS, seed=5)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        model, params, _ = load_qwen3_gguf(path, max_rope_len=4096)
        _sync(device)
        t2 = time.perf_counter()
    require(model.device.type == device
            and params["embed"]["w"].dtype == torch.bfloat16,
            f"load_qwen3_gguf defaults: {model.device}, "
            f"{params['embed']['w'].dtype}")
    c = model.config
    lay = fuse_decode_params(params)["layers"]
    grids = {name: "q4" if "q4" in p else "q8" for name, p in
             (("qkv", lay["qkv"]), ("o", lay["o"]),
              ("gateup", lay["mlp"]["gateup"]), ("down", lay["mlp"]["down"]),
              ("head", params["lm_head"]))}
    require(grids == {"qkv": "q4", "o": "q4", "gateup": "q4", "down": "q8",
                      "head": "q8"}, f"GGUF grids {grids}")
    log(f"[gguf] (m) Qwen3 GGUF, H={c.hidden_size} I={c.intermediate_size} "
        f"V={c.vocab_size}, {c.num_hidden_layers} layers (depth cut from "
        f"28): {size / 1e6:.1f} MB written in {t1 - t0:.1f} s, loaded onto "
        f"the card in {t2 - t1:.1f} s (set-up, the default device and "
        f"dtype); grids {grids}")
    V = c.vocab_size
    rng = np.random.default_rng(600)
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=4096)
    eng.generate_tokens(_prompt(rng, 64, V), SamplingConfig(), 16)    # warm
    ids = _prompt(rng, 64, V)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, SamplingConfig(), max_tokens=32)
    _sync(device)
    launches = read_counts(wr, "gguf", ("quant_matmul_q4", "quant_swiglu",
                                        "head_argmax_q8",
                                        "fused_decode_stack_q8"))
    require(launches["fused_decode_stack"] == 0,
            "the GGUF path ran the bf16 fused stack")
    require(len(out) == 32 and all(0 <= t < V for t in out),
            f"GGUF TextEngine: {len(out)} tokens")
    eager_twin("(m) GGUF file, quantized fused stack", eng,
               lambda: TextEngine(model, params, eos_token_ids=[],
                                  max_seq_len=4096, cuda_graphs=False),
               _requests([(ids, SamplingConfig(), 32)]), [out], launches,
               device)
    t = eng.last_timing
    card = card_line() if device == "cuda" else "cpu"
    log(f"[gguf] 64-token prompt: 32 greedy tokens, prefill "
        f"{t.prompt_secs * 1e3:.2f} ms, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at batch "
        f"1 (quantized fused stack) | {card}")

    # teacher-forced, through each decode path on the card
    forced = out[:8]
    cpu_model = type(model)(c, max_rope_len=4096, device="cpu")
    exact_params = _tree_to(eng.params, "cpu", torch.float32)
    witness_params = _tree_to(eng.params, "cpu", None)
    hx, _ = teacher_forced_hidden(cpu_model, exact_params, ids, forced, "cpu")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    for path, window in (("fused stack", 512), ("per-op chain", None)):
        hk, gk = teacher_forced_hidden(model, eng.params, ids, forced, device,
                                       window)
        with card_routes_on_cpu():
            hw, gw = teacher_forced_hidden(cpu_model, witness_params, ids,
                                           forced, "cpu", window)
            hn, _ = teacher_forced_hidden(cpu_model,
                                          _nudge_scales(witness_params), ids,
                                          forced, "cpu", window)
        bad, _ = teacher_forced_hidden(model, _zero_scales(eng.params), ids,
                                       forced, device, window)
        rel_w, rel_x = rel(hk, hw), rel(hk, hx)
        by_pos = " ".join(f"{rel(hk[i], hw[i]):.1e}" for i in range(len(hk)))
        agree = sum(x == y for x, y in zip(gk, gw))
        log(f"[gguf] teacher-forced 9 positions (prefill + 8 steps), {path}: "
            f"hidden max err vs the witness (CPU, bf16, the plain versions) "
            f"{rel_w:.3e} of max |ref| (tol {TOL_GGUF_WITNESS_REL}; by "
            f"position {by_pos}); the witness with every scale nudged by one "
            f"f32 ulp {rel(hn, hw):.3e} from it; vs the exact path (CPU, f32, "
            f"dequantized) {rel_x:.3e} (tol {TOL_GGUF_REL}), the witness "
            f"itself {rel(hw, hx):.3e}; zeroed scales {rel(bad, hw):.3g} / "
            f"{rel(bad, hx):.3g}; greedy agreement with the witness "
            f"{agree}/{len(gk)}")
        require(rel_w <= TOL_GGUF_WITNESS_REL,
                f"GGUF {path} off the witness by {rel_w}")
        require(rel_x <= TOL_GGUF_REL, f"GGUF {path} off exact by {rel_x}")
        require(rel(bad, hw) > TOL_GGUF_WITNESS_REL
                and rel(bad, hx) > TOL_GGUF_REL,
                "zeroed scales pass the GGUF bounds")


def phase_quant(model, params, device: str = "cuda") -> None:
    """(j)-(m): the GGUF grids on the card."""
    from aha_tpu_torch.models.qwen3 import pack_params

    for grid in ("q8", "q4"):
        t0 = time.perf_counter()
        packed = pack_params(params, grid)
        _sync(device)
        log(f"[{grid}-text] weights and head packed {grid} on the card in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")
        _quant_text_path(model, packed, grid, device)
        if grid == "q4":
            _batch_path(model, packed, device, torch.bfloat16, "batch-q4",
                        ("quant_matmul_q4", "quant_swiglu"))
        del packed
        if device == "cuda":
            torch.cuda.empty_cache()
    _gguf_path(model.config, device)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device, dtype):
    """The tree on `device`, its float tensors in `dtype` (the grids'
    integer tensors keep theirs)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype if tree.is_floating_point()
                   else tree.dtype)


# -- 6b. MiniCPM4-0.5B: the llama family on both engines (s) ------------------

#: the depth of the MiniCPM4 checkpoint the HTTP phase serves (full width)
MINICPM_HTTP_LAYERS = 4


def phase_minicpm(device: str = "cuda") -> dict:
    """(s1) a TextEngine: a 300-token prompt (bucket 512, the prefill
    kernel at 16/2, D 64) and 64 greedy tokens, every decode step 24
    launches of flash_decode_at_layer; (s2) a BatchEngine of 8 slots with
    the prefix store under the (f) request mix (one sampled request,
    chunked admission); each graphed and eager; then 8 teacher-forced
    steps of 4 slots against the f32 plain path on the CPU."""
    from aha_tpu_torch.core.engine import TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.llama import LlamaModel, minicpm4_0_5b

    cfg = minicpm4_0_5b()
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = LlamaModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(4),
                               dtype=torch.bfloat16)
    fused = model.fuse_params(params)
    _sync(device)
    n_params = sum(t.numel() for name, t in params.items()
                   if name != "lm_head" for t in _leaves(t))
    log(f"[minicpm] MiniCPM4-0.5B geometry L={L} H={cfg.hidden_size} "
        f"Hq/Hkv={cfg.num_attention_heads}/{cfg.num_key_value_heads} "
        f"D={model.head_dim} V={V} tied, scale_emb {cfg.scale_emb}, "
        f"residual x{model.residual_scale:.4f}, hidden x"
        f"{model.hidden_scale:.4f}, LongRoPE: {n_params / 1e6:.1f} M bf16 "
        f"params seeded on the card in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")
    rng = np.random.default_rng(15)
    greedy = SamplingConfig()
    warm = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    warm.generate_tokens(_prompt(rng, 300, V), greedy, max_tokens=32)
    del warm
    eng = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    ids = _prompt(rng, 300, V)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, greedy, max_tokens=64)
    _sync(device)
    counts = read_counts(wr, "minicpm-text", ("flash_attention",
                                              "flash_decode_at_layer"))
    require(len(out) == 64 and all(0 <= t < V for t in out),
            f"(s1): {len(out)} tokens")
    require(counts["flash_attention"] == L
            and counts["flash_decode_at_layer"] == L * 64,
            f"(s1) launches {counts}: {L} prefill, {L * 64} decode expected")
    t = eng.last_timing
    card = card_line() if device == "cuda" else "cpu"
    log(f"[minicpm] (s1) 300-token prompt, bucket 512 kernel prefill "
        f"{t.prompt_secs * 1e3:.2f} ms; 64 greedy tokens, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at "
        f"batch 1 (per-op chain, no fused stack) | {card}")
    eager_twin("(s1) MiniCPM4-0.5B TextEngine", eng, lambda: TextEngine(
        model, fused, eos_token_ids=[], max_seq_len=8192, cuda_graphs=False),
        _requests([(ids, greedy, 64)]), [out], counts, device)
    del eng

    r = _batch_path(model, fused, device, torch.bfloat16, "minicpm-batch",
                    ("flash_attention", "flash_decode_at_layer"),
                    prefix_cache_entries=4)
    chunk = 512                       # BatchEngine's default prefill_chunk
    whole = [n for n in r["prompts"] if n <= chunk and bucket_for(n) >= 128]
    require(r["block"]["flash_decode_at_layer"] == L * r["blk"]
            and r["launches"]["flash_decode_at_layer"] == L * r["steps"]
            and r["launches"]["flash_attention"] == L * len(whole),
            f"(s2) launches {r['launches']} (a block: {r['block']}) over "
            f"{r['steps']} steps; {L * len(whole)} prefill launches expected "
            f"for the {len(whole)} prompts admitted in one kernel prefill")
    log(f"[minicpm] (s2) flash_attention {L} a one-chunk prefill of >= 128 "
        f"rows ({len(whole)} prompts), flash_decode_at_layer {L} a step of "
        f"8 slots ({r['steps']} steps)")
    _teacher_forced_4_slots(model, fused, device, (torch.bfloat16,),
                            "minicpm")
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"model": model, "params": params}


# -- 6c. embeddings and reranking (t) -------------------------------------------


def _smoke_tokenizer(tmp: str):
    """tests/fixtures.py's test tokenizer written under `tmp`, loaded by
    file path (a `tests` package elsewhere on sys.path must not shadow
    it); returns the fixtures module and the tokenizer."""
    spec = importlib.util.spec_from_file_location(
        "aha_test_fixtures", os.path.join(ROOT, "tests", "fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    return fixtures, fixtures.build_tokenizer(tmp)


_EMBED_WORDS = ("hello world how are you today the quick brown fox jumps "
                "over the lazy dog what is the answer to life").split()


def _embed_texts(tok, lens: tuple[int, ...], seed: int) -> list[str]:
    """Seeded word strings, each grown until it encodes to at least its
    length in `lens` (one text a length)."""
    rng = np.random.default_rng(seed)
    texts = []
    for n in lens:
        words: list[str] = []
        while len(tok.encode(" ".join(words)).ids) < n:
            words.append(_EMBED_WORDS[rng.integers(len(_EMBED_WORDS))])
        texts.append(" ".join(words))
    return texts


#: (t1)'s 12 texts: token counts over the 32, 128 and 512 buckets (5 in
#: the 512 one)
EMBED_LENS = (5, 17, 30, 70, 100, 120, 128, 260, 300, 400, 470, 505)
#: (t3)'s 12 texts over MiniLM's 16-512 buckets, one past its 512 positions
MINILM_LENS = (3, 9, 15, 20, 31, 40, 60, 64, 100, 200, 300, 600)


def phase_embed(qwen_model, qwen_params: dict, device: str = "cuda") -> dict:
    """(t1) Qwen3-Embedding-0.6B on phase 4's Qwen3-0.6B weights: 12 texts
    over the 32, 128 and 512 buckets, flash_attention 28 a group at a
    bucket of 128 or more (B = the group's rows); every vector unit-norm
    and within TOL_EMBED_REL of the f32 plain path on the CPU.  (t2)
    Qwen3-Reranker-0.6B on the same weights: scores equal to the vectors'
    dot products, the order printed.  (t3) all-MiniLM-L6-v2 at its full
    geometry, f32: 12 texts on the card against the CPU within
    TOL_MINILM.  Returns MiniLM's config, parameters, texts and vectors."""
    from aha_tpu_torch.core.engine import bucket_for
    from aha_tpu_torch.core.tokenizer import TokenizerModel
    from aha_tpu_torch.models.minilm import BertConfig, BertModel
    from aha_tpu_torch.models.minilm_served import MiniLMServed
    from aha_tpu_torch.models.qwen3_served import (Qwen3EmbeddingServed,
                                                   Qwen3RerankerServed)
    from aha_tpu_torch.registry import lookup

    card = card_line() if device == "cuda" else "cpu"
    L = qwen_model.config.num_hidden_layers
    with tempfile.TemporaryDirectory(prefix="aha_torch_tok_") as tmp:
        _, tok = _smoke_tokenizer(tmp)
        tokenizer = TokenizerModel.init(tmp)
    texts = _embed_texts(tok, EMBED_LENS, 16)
    lens = [len(tokenizer.encode(t)) for t in texts]
    groups: dict[int, int] = {}
    for n in lens:
        groups[bucket_for(n)] = groups.get(bucket_for(n), 0) + 1
    require(set(groups) == {32, 128, 512} and groups[512] >= 4,
            f"(t) token counts {lens} fill buckets {groups}")
    emb = Qwen3EmbeddingServed(lookup("Qwen/Qwen3-Embedding-0.6B"),
                               qwen_model, qwen_params, tokenizer)
    emb.embed_arrays(texts)                                  # warm-up
    wr = zero_counts()
    _sync(device)
    t0 = time.perf_counter()
    vecs = emb.embed_arrays(texts)
    _sync(device)
    secs = time.perf_counter() - t0
    counts = read_counts(wr, "embed", ("flash_attention",))
    big = [b for b in groups if b >= 128]
    require(counts["flash_attention"] == L * len(big),
            f"(t1) flash_attention {counts['flash_attention']}, "
            f"{L} x {len(big)} groups at >= 128 rows expected")
    norms = np.linalg.norm(vecs, axis=-1)
    require(np.all(np.abs(norms - 1) < 1e-4), f"(t1) norms {norms}")
    cpu_model, cpu_params = _f32_cpu(qwen_model, qwen_params)
    cpu = Qwen3EmbeddingServed(emb.entry, cpu_model, cpu_params, tokenizer)
    ref = cpu.embed_arrays(texts)
    rel = float(np.abs(vecs - ref).max() / np.abs(ref).max())
    cos = float((vecs * ref).sum(-1).min())
    log(f"[embed] (t1) Qwen3-Embedding-0.6B, 12 texts of {min(lens)}-"
        f"{max(lens)} tokens in groups {dict(sorted(groups.items()))} "
        f"(rows padded to powers of two): unit-norm; max err {rel:.3e} of "
        f"max |ref| against the f32 plain path on the CPU (tol "
        f"{TOL_EMBED_REL}), least cosine {cos:.5f}; flash_attention "
        f"{counts['flash_attention']} ({L} a group at >= 128 rows); "
        f"{secs * 1e3:.1f} ms for the 12 | {card}")
    require(rel <= TOL_EMBED_REL, f"(t1) vectors off by {rel}")
    del cpu, cpu_params, cpu_model

    rr = Qwen3RerankerServed(lookup("Qwen/Qwen3-Reranker-0.6B"), emb)
    query, docs = texts[1], texts[2:]
    scores = np.asarray(rr.rerank(query, docs))
    qd = emb.embed_arrays([query] + docs)
    dots = qd[1:] @ qd[0]
    require(np.abs(scores - dots).max() <= 1e-6,
            f"(t2) scores {scores} vs dots {dots}")
    order = [int(i) for i in np.argsort(-scores)]
    log(f"[embed] (t2) Qwen3-Reranker-0.6B: {len(docs)} documents' scores "
        f"equal the vectors' dot products; order {order}, scores "
        f"{[round(float(scores[i]), 5) for i in order]}")

    bcfg = BertConfig()
    bert = BertModel(bcfg, device=device)
    bparams = bert.init_random(torch.Generator(device=device).manual_seed(6))
    mini = MiniLMServed(lookup("sentence-transformers/all-MiniLM-L6-v2"),
                        bert, bparams, tokenizer)
    mtexts = _embed_texts(tok, MINILM_LENS, 17)
    mini.embedding(mtexts)                                   # warm-up
    _sync(device)
    t0 = time.perf_counter()
    mv = np.asarray(mini.embedding(mtexts))
    _sync(device)
    msecs = time.perf_counter() - t0
    cmini = MiniLMServed(mini.entry, BertModel(bcfg, device="cpu"),
                         _tree_to(bparams, "cpu", torch.float32), tokenizer)
    mref = np.asarray(cmini.embedding(mtexts))
    merr = float(np.abs(mv - mref).max())
    log(f"[embed] (t3) all-MiniLM-L6-v2 (vocab {bcfg.vocab_size}, "
        f"{bcfg.hidden_size} x {bcfg.num_hidden_layers}, "
        f"{bcfg.num_attention_heads} heads, {bcfg.intermediate_size}, f32): "
        f"12 texts, max err {merr:.3e} against the CPU (tol {TOL_MINILM}); "
        f"{msecs * 1e3:.1f} ms for the 12 | {card}")
    require(merr <= TOL_MINILM, f"(t3) MiniLM off by {merr}")
    return {"config": bcfg, "params": bparams, "vectors": mv,
            "texts": mtexts}


def phase_http_embed(minilm: dict, minicpm: dict) -> None:
    """Two more `python -m aha_tpu_torch serv` children under -X
    importtime: (1) a MiniLM checkpoint served as
    sentence-transformers/all-MiniLM-L6-v2 — /v1/embeddings with a string
    and with an array equal to the in-process vectors, /v1/rerank refused
    400 with the reference's message; (2) a MiniCPM4 checkpoint in HF
    names (full width, MINICPM_HTTP_LAYERS layers) served as
    OpenBMB/MiniCPM4-0.5B with --batch-slots 4, answering 4 chats at once.
    (The Qwen3 reranker's server is phase_http's.)"""
    from aha_tpu_torch.io.weights import save_hf_bert, save_hf_qwen3
    from aha_tpu_torch.models.llama import minicpm4_0_5b

    cut = minicpm4_0_5b(MINICPM_HTTP_LAYERS)
    p = minicpm["params"]
    with contextlib.ExitStack() as stack:
        tmp, tmp_cpm = (stack.enter_context(tempfile.TemporaryDirectory(
            prefix=f"aha_torch_{kind}_")) for kind in ("minilm", "minicpm"))
        _smoke_tokenizer(tmp)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({**minilm["config"].__dict__,
                       "architectures": ["BertModel"], "model_type": "bert"},
                      f)
        save_hf_bert(minilm["params"], tmp)
        fixtures, tok = _smoke_tokenizer(tmp_cpm)
        eos = tok.token_to_id("<|im_end|>")
        embed = p["embed"]["w"].clone()
        # replies stay in the test tokenizer's vocabulary
        embed[tok.get_vocab_size(with_added_tokens=True):] = 0
        cut_params = {"embed": {"w": embed}, "norm": p["norm"],
                      "lm_head": {"w": embed},
                      "layers": _tree_map(lambda t: t[:MINICPM_HTTP_LAYERS],
                                          p["layers"])}
        with open(os.path.join(tmp_cpm, "config.json"), "w") as f:
            json.dump({**cut.__dict__,
                       "architectures": ["MiniCPMForCausalLM"],
                       "model_type": "minicpm", "torch_dtype": "bfloat16",
                       "eos_token_id": eos}, f)
        with open(os.path.join(tmp_cpm, "generation_config.json"), "w") as f:
            json.dump({"eos_token_id": [eos]}, f)
        with open(os.path.join(tmp_cpm, "tokenizer_config.json"), "w") as f:
            json.dump({"chat_template": fixtures.CHAT_TEMPLATE}, f)
        save_hf_qwen3(cut_params, tmp_cpm)
        del embed, cut_params
        texts = minilm["texts"]
        with _servers(
                (tmp, ("--model", "sentence-transformers/all-MiniLM-L6-v2")),
                (tmp_cpm, ("--model", "OpenBMB/MiniCPM4-0.5B",
                           "--batch-slots", "4"))) as (base, base_cpm):
            for inp, want in ((texts[3], minilm["vectors"][3:4]),
                              (texts, minilm["vectors"])):
                status, text = _post(base + "/v1/embeddings", {"input": inp})
                got = np.asarray([d["embedding"]
                                  for d in json.loads(text)["data"]])
                err = float(np.abs(got - want).max())
                require(status == 200 and got.shape == want.shape
                        and err <= 1e-6, f"/v1/embeddings {status}: err "
                        f"{err}, shape {got.shape}")
            status, text = _post(base + "/v1/rerank",
                                 {"query": "q", "documents": ["d"]})
            require(status == 400 and json.loads(text) == {
                "error": "current model does not support rerank"},
                f"/v1/rerank on MiniLM: {status} {text}")
            log(f"[http] MiniLM: /v1/embeddings of a string and of "
                f"{len(texts)} texts equal to the in-process vectors (within "
                f"1e-6); /v1/rerank refused 400 with the reference's message")
            _ask_concurrent(base_cpm, 4)
    log(f"[http] MiniCPM4-0.5B checkpoint (full width, "
        f"{MINICPM_HTTP_LAYERS} layers) served with --batch-slots 4: 4 "
        f"chats at once")


# -- 7d. the hybrid families: LFM2-1.2B (u) and Qwen3.5 (v) -------------------

#: where a stream restored from the prefix store parts from a cold
#: engine's on the same prompt, the two candidates' f32 CPU logits must lie
#: within this share of the row's max |logit|: the restored path prefills
#: the suffix over the stored state (chunks at other boundaries, sdpa over
#: the cache with bf16 probabilities) where the cold one prefills it whole
#: (the flash kernel), and 16-24 bf16 layers of seeded weights carry that
#: rounding to near-ties of a 65,536- or 151,936-way flat head.  Measured
#: on an H100: 9 partings in 128 tokens over (u1) and (v1), gaps 2.4e-3 to
#: 2.06e-2 of max |logit| (the bound 2.4x the largest).  This bound only
#: says that a parting is a near-tie; what holds the restore itself is
#: _restore_check (hidden states against the cold path's, and a planted
#: broken restore that must fail it)
TOL_HYBRID_TIE_REL = 5e-2
#: the hybrids' cut depth for the teacher-forced check and the served
#: checkpoints: their first 4 layers (3 mixer layers and 1 attention layer
#: in both), at full width
HYBRID_CUT = 4
#: per hybrid reading: a decode block's wall, device busy and idle share,
#: and the plain mixers' device times (printed as one JSON line before the
#: kernels line)
HYBRID_READINGS: list[dict] = []


def _hybrid_model(family: str, device: str, layers: int | None = None):
    """LFM2-1.2B's published geometry, or the reference's default Qwen3.5
    text config; `layers` keeps the first ones."""
    from aha_tpu_torch.models import lfm2, qwen3_5

    if family == "lfm2":
        return lfm2.Lfm2Model(lfm2.lfm2_1_2b(layers), max_rope_len=8192,
                              device=device)
    return qwen3_5.Qwen3_5Model(qwen3_5.qwen3_5_text_default(layers),
                                max_rope_len=8192, device=device)


def _block_idle(eng, ids: list[int], device: str) -> dict:
    """One 16-step greedy decode block of a TextEngine from the prefilled
    prompt (the replay of its graph, or the eager steps): wall, device busy
    and idle share (profile_decode's reading)."""
    from aha_tpu_torch.core.engine import bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.utils.profile_decode import _read

    st = eng._take(512)
    greedy = SamplingConfig()

    def block():
        st.cache["pos"].fill_(len(ids))
        eng._decode_block(st, greedy, 16, len(ids) + 17)

    try:
        with torch.no_grad():
            eng._prefill(ids, bucket_for(len(ids)), st.cache,
                         from_cache=False)
            for _ in range(2):          # warm-up: allocator, the capture
                block()
            return _read(block, 16) if device == "cuda" else {}
    finally:
        eng._return(st)


def _suffix_hidden(model, params, ids: list[int], p: int,
                   forced: list[int], device: str, entry: dict | None = None,
                   mm: dict | None = None) -> torch.Tensor:
    """The final hidden states of ids[p:] and of `forced` fed one token a
    step after them: with `entry`, ids[p:] prefilled over the snapshot
    restored at p (PrefixStore.restore, as the engine resumes); without,
    all of `ids` prefilled cold (with its images or frames `mm`, on the
    device) and its rows from p kept."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import PrefixStore, bucket_for

    cache = model.init_cache(1, max(512, bucket_for(len(ids)),
                                    len(ids) + len(forced)),
                             embed_dtype(params))
    toks, first = (ids[p:], 0) if entry is not None else (ids, p)
    if entry is not None:
        PrefixStore.restore(entry, cache, p)
    x = torch.zeros((1, bucket_for(len(toks))), dtype=torch.int64)
    x[0, :len(toks)] = torch.tensor(toks)
    hs = [model.backbone(params, x.to(device), cache, prompt_len=len(toks),
                         from_cache=entry is not None,
                         **({} if entry is not None or mm is None
                            else {"mm": mm}))[0, first:len(toks)]]
    kv.advance(cache, len(toks))
    for t in forced:
        tok = torch.tensor([[t]], device=device)
        hs.append(model.backbone(params, tok, cache)[0])
        kv.advance(cache, 1)
    return torch.cat(hs)


def _row_rel(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's max |got - ref| over the row's max |ref|, in f32."""
    got, ref = got.float(), ref.float()
    return (got - ref).abs().amax(-1) / ref.abs().amax(-1)


def _restore_check(tag: str, model, params, ids: list[int], entry: dict,
                   p: int, forced: list[int], device: str,
                   mm: dict | None = None, drop: tuple[str, ...] | None = None,
                   dropped: str = "the rolling state", label: str | None = None,
                   phase: str = "hybrid") -> dict:
    """The restored path's hidden states (the suffix ids[p:] prefilled over
    `entry`, then `forced` teacher-forced) against the cold path's on the
    same tokens (prefilled with the images or frames `mm`), each row within
    TOL_HIDDEN_REL of its max |ref|; the same with a planted broken restore
    (the entry less `drop`, by default its rolling state kv.STATE_KEYS)
    must exceed it.  Over the rows that pick a token (the suffix's last and
    each forced step's), per row over its max |logit|: the cold path's
    top-two gap, how far the restored path moves that difference, and the
    rows where the two paths' argmax differ — a greedy stream parts where
    the move passes the gap."""
    from aha_tpu_torch.core import cache as kv

    drop = kv.STATE_KEYS if drop is None else drop
    label = f"({tag}1)" if label is None else label
    with torch.no_grad():
        cold = _suffix_hidden(model, params, ids, p, forced, device, mm=mm)
        warm = _suffix_hidden(model, params, ids, p, forced, device, entry)
        broken = _suffix_hidden(model, params, ids, p, forced, device,
                                {k: v for k, v in entry.items()
                                 if k not in drop})
        err = float(_row_rel(warm, cold).max())
        bad = float(_row_rel(broken, cold).max())
        picks = slice(len(ids) - p - 1, None)
        lc = model.logits(params, cold[None, picks])[0].float()
        lw = model.logits(params, warm[None, picks])[0].float()
        top = lc.abs().amax(-1)
        pair = lc.topk(2, dim=-1).indices

        def diff(lg):
            two = lg.gather(-1, pair)
            return two[:, 0] - two[:, 1]

        gap = (diff(lc) / top).cpu()
        move = ((diff(lw) - diff(lc)).abs() / top).cpu()
        flips = int((lw.argmax(-1) != lc.argmax(-1)).sum())
    log(f"[{phase}] {label} restore check, {len(ids) - p} suffix rows + "
        f"{len(forced)} teacher-forced steps: hidden max err {err:.3e} of "
        f"the row's max |ref| against the cold path (tol {TOL_HIDDEN_REL}); "
        f"a restore less {dropped} {bad:.3e} (must exceed the tol); "
        f"of {len(gap)} rows that pick a token: top-two gap median "
        f"{float(gap.median()):.3e}, its move median "
        f"{float(move.median()):.3e} max {float(move.max()):.3e}, argmax "
        f"differs on {flips}")
    require(err <= TOL_HIDDEN_REL, f"{label} the restored path's hidden "
            f"states off the cold path's by {err}")
    require(bad > TOL_HIDDEN_REL, f"{label} a restore without {dropped} "
            f"passes the check ({bad} <= {TOL_HIDDEN_REL})")
    return {"hidden_err_rel": err, "broken_restore_err_rel": bad,
            "top2_gap_median": float(gap.median()),
            "top2_move_median": float(move.median()),
            "top2_move_max": float(move.max()), "argmax_flips": flips,
            "rows": len(gap)}


def _hybrid_text(tag: str, name: str, model, fused, params, device: str,
                 n_attn: int) -> None:
    """(u1)/(v1): a TextEngine with the prefix store, a 300-token prompt
    (bucket 512: the prefill kernel) and 64 greedy tokens, graphed and
    eager; the prompt extended by 40 tokens, restored from the store
    (rows and rolling state) and prefilled from 300, held to a cold
    engine's stream; the exact repeat, which must match no entry, equal to
    the cold stream; one decode block's idle share, graphed and eager."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig

    V = model.config.vocab_size
    rng = np.random.default_rng(16)
    greedy = SamplingConfig()
    card = card_line() if device == "cuda" else "cpu"
    warm = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    warm.generate_tokens(_prompt(rng, 300, V), greedy, max_tokens=32)
    del warm
    eng = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                     prefix_cache_entries=4)
    ids = _prompt(rng, 300, V)
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, greedy, max_tokens=64)
    _sync(device)
    counts = read_counts(wr, f"{name}-text", ("flash_attention",
                                              "flash_decode_at_layer"))
    require(len(out) == 64 and all(0 <= t < V for t in out),
            f"({tag}1): {len(out)} tokens")
    require(counts["flash_attention"] == n_attn
            and counts["flash_decode_at_layer"] == n_attn * 64,
            f"({tag}1) launches {counts}: {n_attn} prefill, {n_attn * 64} "
            f"decode expected")
    t = eng.last_timing
    log(f"[hybrid] ({tag}1) 300-token prompt, bucket 512 kernel prefill "
        f"{t.prompt_secs * 1e3:.2f} ms; 64 greedy tokens, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at "
        f"batch 1 | {card}")
    eager_twin(f"({tag}1) {name} TextEngine", eng, lambda: TextEngine(
        model, fused, eos_token_ids=[], max_seq_len=8192, cuda_graphs=False),
        _requests([(ids, greedy, 64)]), [out], counts, device)

    store = eng._prefix_entries
    require(store.match(ids) == (None, 0), f"({tag}1): an exact repeat "
            f"matched a state-carrying prefix entry")
    ext = ids + _prompt(rng, 40, V)
    entry, p = store.match(ext)
    require(p == len(ids) and entry is not None and "conv" in entry,
            f"({tag}1): the extension restores from {p}")
    cold = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    wr = zero_counts()
    got = eng.generate_tokens(ext, greedy, max_tokens=64)
    _sync(device)
    c_ext = read_counts(wr, f"{name}-prefix", ("flash_decode_at_layer",))
    require(c_ext["flash_attention"] == 0, f"({tag}1) extension: the "
            f"40-token suffix prefilled through the kernel")
    tie = _walk_ties(f"({tag}1) prefix-store extension", cold, got, ext,
                     model, params, {}, tag="hybrid",
                     tol=TOL_HYBRID_TIE_REL)
    HYBRID_READINGS.append({
        "path": f"({tag}1) {name} prefix-store extension", "parts": tie[
            "parts"], **_restore_check(tag, model, fused, ext, entry, p, got,
                                       device), "card": card})
    rep = eng.generate_tokens(ids, greedy, max_tokens=64)
    require(rep == out == cold.generate_tokens(ids, greedy, max_tokens=64),
            f"({tag}1): the exact repeat differs from a cold stream")
    log(f"[hybrid] ({tag}1) the extension restored 300 rows and the rolling "
        f"state, prefilled 40 (parts from the cold stream at "
        f"{tie['parts']}); the exact repeat matched no entry and equals the "
        f"cold stream")
    del cold
    for graphed in (True, False):
        e = eng if graphed else TextEngine(model, fused, eos_token_ids=[],
                                           max_seq_len=8192,
                                           cuda_graphs=False)
        d = _block_idle(e, ids, device)
        if d:
            HYBRID_READINGS.append({
                "path": f"({tag}1) {name} decode block, 16 steps at 301 "
                        f"rows", "graphed": graphed,
                "ms_per_step": d["wall_ms"] / 16,
                "device_busy_ms_per_step": d["device_busy_ms"] / 16,
                "idle_share": d["idle_share"],
                "device_ops_per_step": d["device_ops_per_step"],
                "top_ops": d["top_ops"][:4], "card": card})
            log(f"[hybrid] ({tag}1) decode block "
                f"{'graphed' if graphed else 'eager'}: "
                f"{d['wall_ms'] / 16:.3f} ms/step wall, device busy "
                f"{d['device_busy_ms'] / 16:.3f} ms/step, idle share "
                f"{d['idle_share']:.3f}, {d['device_ops_per_step']:.0f} "
                f"device ops/step | {card}")


#: each hybrid's served id and the server's flags
HYBRID_SERVE = {"lfm2": ("LiquidAI/LFM2-1.2B", ("--batch-slots", "4")),
                "qwen3_5": ("Qwen/Qwen3.5-0.8B", ())}


def _hybrid_checkpoint(tmp: str, name: str, params: dict) -> None:
    """The first HYBRID_CUT layers at full width saved under `tmp` as an
    HF-named checkpoint with the test tokenizer (the tied embedding's rows
    zeroed but those of tokens that decode alone to whole text — no
    special or marker token, no partial UTF-8 byte — so a seeded model's
    replies stream as text)."""
    import dataclasses

    from aha_tpu_torch.io.weights import save_hf_lfm2, save_hf_qwen3_5

    cut = _hybrid_model(name, "cpu", HYBRID_CUT).config
    fixtures, tok = _smoke_tokenizer(tmp)
    eos = tok.token_to_id("<|im_end|>")
    special = set(tok.get_added_tokens_decoder())
    words = [tok.decode([i]) for i in
             range(tok.get_vocab_size(with_added_tokens=True))]
    text = [i for i, w in enumerate(words)
            if i not in special and w.strip() and "\ufffd" not in w]
    embed = torch.zeros_like(params["embed"]["w"])
    keep = torch.tensor(text, device=embed.device)
    embed[keep] = params["embed"]["w"][keep]
    cut_params = {**params, "embed": {"w": embed},
                  "lm_head": {"w": embed},
                  "layers": params["layers"][:HYBRID_CUT]}
    cfg = {**dataclasses.asdict(cut), "torch_dtype": "bfloat16",
           "eos_token_id": eos,
           "layer_types": list(cut.layer_types)}
    cfg.update({"architectures": ["Lfm2ForCausalLM"],
                "model_type": "lfm2"} if name == "lfm2" else
               {"architectures": ["Qwen3_5ForCausalLM"],
                "model_type": "qwen3_5_text"})
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tmp, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(tmp, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": fixtures.CHAT_TEMPLATE}, f)
    (save_hf_lfm2 if name == "lfm2" else save_hf_qwen3_5)(cut_params,
                                                          tmp)
    del embed, cut_params


#: the engine paths' depth of each hybrid, full width: LFM2-1.2B's first 8
#: of 16 layers (2 attention), Qwen3.5's first 12 of 24 (3 attention)
HYBRID_DEPTH = {"lfm2": 8, "qwen3_5": 12}


def _hybrid_family(tag: str, name: str, device: str, tmp: str) -> None:
    """(u) or (v): the seeded bf16 model at full width and HYBRID_DEPTH
    layers through (tag1) TextEngine and (tag2) an 8-slot BatchEngine with
    the prefix store under the (f) mix (chunked admission, one sampled
    request), each graphed and eager; 8 teacher-forced steps of 4 slots at
    HYBRID_CUT layers against the f32 plain path on the CPU; then the cut
    checkpoint written under `tmp` for phase_hybrid's servers."""
    from aha_tpu_torch.core.engine import bucket_for, fused_params

    model = _hybrid_model(name, device, HYBRID_DEPTH[name])
    cfg = model.config
    n_attn = len(model.attn_slot)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(16),
                               dtype=torch.bfloat16)
    fused = fused_params(model, params)
    _sync(device)
    n_params = sum(t.numel() for k, t in params.items() if k != "lm_head"
                   for t in _leaves(t))
    log(f"[hybrid] ({tag}) {name}: {cfg.num_hidden_layers} layers "
        f"({n_attn} attention), hidden {cfg.hidden_size}, vocab "
        f"{cfg.vocab_size}, tied: {n_params / 1e6:.1f} M bf16 params seeded "
        f"on the card in {time.perf_counter() - t0:.1f} s (set-up)")
    _hybrid_text(tag, name, model, fused, params, device, n_attn)

    r = _batch_path(model, fused, device, torch.bfloat16, f"{name}-batch",
                    ("flash_attention", "flash_decode_at_layer"),
                    prefix_cache_entries=4)
    chunk = 512                       # BatchEngine's default prefill_chunk
    whole = [n for n in r["prompts"] if n <= chunk and bucket_for(n) >= 128]
    require(r["block"]["flash_decode_at_layer"] == n_attn * r["blk"]
            and r["launches"]["flash_decode_at_layer"] == n_attn * r["steps"]
            and r["launches"]["flash_attention"] == n_attn * len(whole),
            f"({tag}2) launches {r['launches']} (a block: {r['block']}) over "
            f"{r['steps']} steps; {n_attn * len(whole)} prefill launches "
            f"expected for the {len(whole)} prompts admitted in one kernel "
            f"prefill")
    log(f"[hybrid] ({tag}2) flash_attention {n_attn} a one-chunk prefill of "
        f">= 128 rows ({len(whole)} prompts), flash_decode_at_layer {n_attn} "
        f"a step of 8 slots ({r['steps']} steps)")
    del fused
    cut = _hybrid_model(name, device, HYBRID_CUT)
    cut_params = {**params, "layers": params["layers"][:HYBRID_CUT]}
    _teacher_forced_4_slots(cut, fused_params(cut, cut_params), device,
                            (torch.bfloat16,), f"hybrid ({tag}) {name}")
    del cut_params
    if device == "cuda":
        torch.cuda.empty_cache()
    _hybrid_checkpoint(tmp, name, params)


def _mixer_timings() -> None:
    """The hybrids' plain mixers on the card, for a later kernel design:
    Qwen3.5's recurrent delta-rule step of one layer at B 1 and 8 and its
    chunked rule at S 512 (16 value heads of 128, f32), and LFM2-1.2B's
    short-conv decode step at B 1 and 8 and its prefill at S 512 (D 2048,
    L 3, bf16); device time per call beside the bound of the bytes each
    must move (and the f32 operations of the chunked rule)."""
    from aha_tpu_torch.models.hybrid import causal_conv
    from aha_tpu_torch.models.qwen3_5 import (CHUNK, chunk_gated_delta_rule,
                                              recurrent_gated_delta_rule)

    g = torch.Generator(device="cuda").manual_seed(35)
    card = card_line()
    H, Dk, Dv = 16, 128, 128

    def inputs(B, S):
        f = dict(device="cuda", dtype=torch.float32)
        q, k = (torch.nn.functional.normalize(
            torch.randn((B, S, H, Dk), generator=g, **f), dim=-1)
            for _ in range(2))
        v = torch.randn((B, S, H, Dv), generator=g, **f)
        gg = -torch.rand((B, S, H), generator=g, **f) * 0.1
        beta = torch.rand((B, S, H), generator=g, **f)
        state = torch.randn((B, H, Dk, Dv), generator=g, **f) * 0.1
        return q, k, v, gg, beta, state

    rows = []
    for B in (1, 8):
        a = inputs(B, 1)
        ms = device_ms(lambda: recurrent_gated_delta_rule(*a), iters=48)
        nbytes = 2 * B * H * Dk * Dv * 4 + B * H * (2 * Dk + 2 * Dv + 2) * 4
        rows.append(("delta rule, recurrent step", f"B={B}", ms,
                     bound(nbytes, 6 * B * H * Dk * Dv, "f32")))
    S = 512
    a = inputs(1, S)
    ms = device_ms(lambda: chunk_gated_delta_rule(*a), iters=10)
    C, N = CHUNK, S // CHUNK
    ops = N * H * (10 * C * C * Dk + 6 * C * Dk * Dv + C ** 3 // 3)
    nbytes = S * H * (2 * Dk + 2 * Dv + 2) * 4 + 2 * H * Dk * Dv * 4
    rows.append(("delta rule, chunked", f"B=1 S={S}", ms,
                 bound(nbytes, ops, "f32")))
    D, L = 2048, 3
    bf = dict(device="cuda", dtype=torch.bfloat16)
    w = torch.randn((L, D), generator=g, **bf)
    for B, S in ((1, 1), (8, 1), (1, 512)):
        x = torch.randn((B, S, D), generator=g, **bf)
        state = torch.zeros((B, L, D), **bf)
        ms = device_ms(lambda: causal_conv(x, w, state, S, False), iters=48)
        nbytes = (2 * B * S * D + 2 * B * L * D + L * D) * 2
        rows.append(("short conv", f"B={B} S={S}", ms,
                     bound(nbytes, 2 * L * B * S * D)))
    for what, at, ms, b in rows:
        log(f"[hybrid] plain {what} at {at}: device ms/call {ms:.4f}; bound "
            f"{b[0]:.4f} ({b[1]}) | {card}")
        HYBRID_READINGS.append({"path": f"plain {what}", "at": at, "ms": ms,
                                "bound_ms": b[0], "bound_by": b[1],
                                "card": card})


def phase_hybrid(device: str = "cuda") -> None:
    """7d: (u) LFM2-1.2B, then (v) Qwen3.5, each through _hybrid_family;
    both cut checkpoints served by `python -m aha_tpu_torch serv` children
    started together under -X importtime (LFM2 with --batch-slots 4, four
    chats at once; Qwen3.5 a non-stream, a stream and a repeat chat);
    then the plain mixers' device times."""
    families = (("u", "lfm2"), ("v", "qwen3_5"))
    with contextlib.ExitStack() as stack:
        tmps = [stack.enter_context(tempfile.TemporaryDirectory(
            prefix=f"aha_torch_{name}_")) for _, name in families]
        for (tag, name), tmp in zip(families, tmps):
            _hybrid_family(tag, name, device, tmp)
            if device == "cuda":
                torch.cuda.empty_cache()
        with _servers(*((tmp, ("--model", HYBRID_SERVE[name][0],
                               *HYBRID_SERVE[name][1]))
                        for (_, name), tmp in zip(families, tmps))) as bases:
            for base, (tag, name) in zip(bases, families):
                model_id, extra = HYBRID_SERVE[name]
                if "--batch-slots" in extra:
                    _ask_concurrent(base, 4)
                else:
                    _ask(base)
                log(f"[http] ({tag}) {model_id} checkpoint (full width, "
                    f"{HYBRID_CUT} layers) served "
                    f"{' '.join(extra) or 'single-stream'}")
    if device == "cuda":
        _mixer_timings()


# -- 6. HTTP ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict) -> tuple[int, str]:
    """(status, body) of a JSON POST, an HTTP error's too."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


#: the depth of the Qwen3 checkpoint the HTTP phase serves (full width)
HTTP_LAYERS = 4


def phase_http(config, params: dict) -> None:
    """The Qwen3 weights cut to HTTP_LAYERS at full width, served by six
    children started together: the servers replay captured decode blocks;
    a server started with `--eager` must give the same greedy replies, and
    so must one started with `--spec-tokens 8` (speculative rounds,
    greedy-exact); then `--batch-slots 4`, graphed and eager, and the
    reranker."""
    import dataclasses

    with tempfile.TemporaryDirectory(prefix="aha_torch_smoke_") as tmp:
        _write_checkpoint(tmp, dataclasses.replace(
            config, num_hidden_layers=HTTP_LAYERS), _text_cut(
                params, HTTP_LAYERS))
        with _servers(*((tmp, extra) for extra in (
                (), ("--spec-tokens", str(SPEC_DRAFTS)), ("--eager",),
                ("--batch-slots", "4"), ("--batch-slots", "4", "--eager"),
                ("--model", "Qwen/Qwen3-Reranker-0.6B")))) as bases:
            plain, spec_base, eager, slots, slots_eager, rerank = bases
            first = _ask(plain)
            spec = _reply(spec_base, _ASK)
            require(spec == first, f"--spec-tokens {SPEC_DRAFTS}: the greedy "
                    f"reply differs from the plain server's: {spec!r} vs "
                    f"{first!r}")
            log(f"[http] --spec-tokens {SPEC_DRAFTS}: the greedy reply equals "
                f"the plain server's")
            _same_replies("single stream", [first], [_reply(eager, _ASK)])
            replies = _ask_concurrent(slots, 4)
            _same_replies("--batch-slots 4", replies,
                          _ask_concurrent(slots_eager, 4))
            _ask_rerank(rerank)


def _ask_rerank(base: str) -> None:
    """/v1/rerank with top_n on the Qwen3 checkpoint served as
    Qwen/Qwen3-Reranker-0.6B: 200, top_n results sorted by score."""
    docs = [f"document {i}: the quick brown fox " + "jumps " * i
            for i in range(6)]
    status, text = _post(base + "/v1/rerank", {
        "query": "the lazy dog", "documents": docs, "top_n": 4})
    res = json.loads(text)["results"]
    scores = [r["relevance_score"] for r in res]
    require(status == 200 and len(res) == 4
            and scores == sorted(scores, reverse=True)
            and all(r["document"] == docs[r["index"]] for r in res),
            f"/v1/rerank: {status} {text[-500:]}")
    log(f"[http] Qwen3-Reranker-0.6B: /v1/rerank top_n 4 of {len(docs)}, "
        f"sorted: indices {[r['index'] for r in res]}, scores "
        f"{[round(x, 5) for x in scores]}")


def _same_replies(what: str, graphed: list, eager: list) -> None:
    require(graphed == eager, f"{what}: the eager server's replies differ: "
            f"{graphed} vs {eager}")
    log(f"[graphs] HTTP {what}: {len(eager)} greedy replies of the "
        f"graphed server equal to an --eager server's")


def _reply(base: str, body: dict) -> str:
    """A non-stream chat's reply text (content, else reasoning)."""
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": False})
    msg = json.loads(text)["choices"][0]["message"]
    require(status == 200, text[-500:])
    return msg.get("content") or msg.get("reasoning_content") or ""


def _write_checkpoint(tmp: str, config, params: dict) -> None:
    """A servable model directory: the test tokenizer and chat template,
    the config, and the seeded weights as safetensors."""
    from aha_tpu_torch.io.weights import save_hf_qwen3

    fixtures, tok = _smoke_tokenizer(tmp)
    eos = tok.token_to_id("<|im_end|>")
    # the seeded model samples from all 151936 ids, the test tokenizer
    # knows ~400: zero the (tied) embedding rows past them, so their
    # logits are 0 and greedy replies are text the tokenizer decodes
    params["embed"]["w"][tok.get_vocab_size(with_added_tokens=True):] = 0
    cfg = {**config.__dict__, "architectures": ["Qwen3ForCausalLM"],
           "torch_dtype": "bfloat16", "eos_token_id": eos}
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tmp, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(tmp, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": fixtures.CHAT_TEMPLATE}, f)
    t0 = time.perf_counter()
    save_hf_qwen3(params, tmp)
    log(f"[http] full-width checkpoint ({config.num_hidden_layers} layers) "
        f"written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")


def _free_ports(n: int) -> list[int]:
    """n distinct free ports (the sockets held open together while they
    are picked)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


@contextlib.contextmanager
def _servers(*specs: tuple):
    """`python -m aha_tpu_torch serv <dir> *extra` in a child process for
    each (dir, extra) of `specs`, all started together and each up and
    answering /health before the body runs (their bases in `specs`'
    order); every child is always stopped, and the -X importtime log of
    each must name no module of jax or aha_tpu."""
    children = []
    try:
        for (tmp, extra), port in zip(specs, _free_ports(len(specs))):
            logf = open(os.path.join(tmp, f"server_{port}.log"), "w")
            proc = subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m", "aha_tpu_torch",
                 "serv", tmp, "--port", str(port), "--max-seq-len", "2048",
                 *extra], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
            children.append((proc, logf, f"http://127.0.0.1:{port}", extra))
        t0 = time.perf_counter()
        for proc, logf, base, extra in children:
            while True:
                if proc.poll() is not None:
                    with open(logf.name) as f:
                        raise RuntimeError("server exited:\n"
                                           + f.read()[-4000:])
                try:
                    with urllib.request.urlopen(base + "/health",
                                                timeout=5) as r:
                        if r.status == 200:
                            break
                except OSError:
                    pass
                require(time.perf_counter() - t0 < 300,
                        "server did not come up")
                time.sleep(1)
            log(f"[http] server {' '.join(extra) or '(single stream)'} up in "
                f"{time.perf_counter() - t0:.1f} s")
        yield [base for _, _, base, _ in children]
    finally:
        for proc, logf, _, _ in children:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logf.close()
    # -X importtime logged every module each child imported, requests
    # served included
    for _, logf, _, _ in children:
        with open(logf.name) as f:
            mods = [ln.rsplit("|", 1)[-1].strip() for ln in f
                    if ln.startswith("import time:")]
        bad = [m for m in mods if m.split(".")[0] in ("jax", "aha_tpu")]
        require(len(mods) > 100 and not bad,
                f"served child imported {bad or 'nothing logged'}")
        log(f"[http] served child imported {len(mods)} modules, none of jax "
            f"or aha_tpu")


@contextlib.contextmanager
def _server(tmp: str, *extra: str):
    """One child of `_servers`: its base URL."""
    with _servers((tmp, extra)) as bases:
        yield bases[0]


def _chat_body(text: str) -> dict:
    return {"model": "Qwen/Qwen3-0.6B", "max_tokens": 24, "temperature": 0.0,
            "messages": [{"role": "user", "content": text}]}


_ASK = _chat_body("the quick brown fox jumps over the lazy dog " * 3)


def _ask(base: str) -> str:
    """Non-stream, stream and a prefix-cache repeat; the first reply's
    text."""
    body = _ASK
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": False})
    resp = json.loads(text)
    u = resp["usage"]
    require(status == 200 and u["prompt_tokens"] >= 32
            and u["completion_tokens"] >= 1, resp)
    msg = resp["choices"][0]["message"]
    first = msg.get("content") or msg.get("reasoning_content") or ""
    log(f"[http] non-stream 200: usage prompt {u['prompt_tokens']} "
        f"completion {u['completion_tokens']}")
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": True})
    events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    require(status == 200 and events[-1] == "[DONE]",
            text[-500:])
    chunks = [json.loads(e) for e in events[:-1]]
    usage = chunks[-1]["usage"]
    n_text = sum(1 for c in chunks for ch in c.get("choices") or []
                 if (ch.get("delta") or {}).get("content")
                 or (ch.get("delta") or {}).get("reasoning_content"))
    require(usage["completion_tokens"] >= 1 and n_text >= 1,
            f"usage {usage}, {n_text} text chunks")
    log(f"[http] stream 200: {len(chunks)} chunks, {n_text} with text, "
        f"usage completion {usage['completion_tokens']}")
    status, text = _post(base + "/v1/chat/completions",
                         {**body, "stream": False})
    u = json.loads(text)["usage"]
    require(status == 200 and u["completion_tokens"] >= 1, text)
    log(f"[http] prefix-cache repeat 200: usage prompt "
        f"{u['prompt_tokens']} completion {u['completion_tokens']}")
    return first


def _ask_concurrent(base: str, n: int) -> list[str]:
    """n chats at once: every one 200 with content; their texts."""
    from concurrent.futures import ThreadPoolExecutor

    texts = [f"request {i}: the quick brown fox jumps over the lazy dog "
             * (2 + i) for i in range(n)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(n) as pool:
        replies = list(pool.map(
            lambda t: _post(base + "/v1/chat/completions",
                            {**_chat_body(t), "stream": False}), texts))
    wall = time.perf_counter() - t0
    out = []
    for status, text in replies:
        resp = json.loads(text)
        msg = resp["choices"][0]["message"]
        out.append(msg.get("content") or msg.get("reasoning_content"))
        require(status == 200 and out[-1]
                and resp["usage"]["completion_tokens"] >= 1, text[-500:])
    log(f"[http] {n} concurrent chats to --batch-slots {n}: all 200 with "
        f"content in {wall:.2f} s")
    return out

# -- 8. Qwen2.5-VL image chat ---------------------------------------------------

#: Qwen2.5-VL-3B-Instruct's special tokens: vision start / end, image pad
VL_VSTART, VL_VEND, VL_IMAGE, VL_VIDEO = 151652, 151653, 151655, 151656
#: the reduced depth of the teacher-forced check and the served checkpoint:
#: 8 vision blocks (block 7 full-attention, as in the published 32) and 4
#: text layers, at the published widths
VL_CUT = dict(depth=8, layers=4, fullatt=(7,))


def _vl_cut(params: dict, depth: int, layers: int) -> dict:
    """The first `depth` vision blocks and `layers` text layers of a
    parameter tree, as views (the tied head stays the embedding)."""
    text = params["text"]
    lay = {k: _tree_map(lambda t: t[:layers], v)
           for k, v in text["layers"].items()}
    return {"visual": {**params["visual"],
                       "blocks": params["visual"]["blocks"][:depth]},
            "text": {**text, "layers": lay}}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _vl_image(side: int, seed: int, **processing):
    """(patches, grid) of a seeded random side x side RGB image through the
    port's Qwen-VL processing (`processing`: preprocess_image_qwen_vl's
    patch size and pixel bounds; Qwen2.5-VL's by default): Pillow decode
    and resize where it is installed, else (said on a line) numpy frames
    straight into patchify_qwen_vl, the same patches a side that is a
    multiple of the grid factor gives without resizing."""
    from aha_tpu_torch.utils import image

    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        return image.preprocess_image_qwen_vl(Image.fromarray(pixels),
                                              **processing)
    log("[vl] Pillow is not installed: patches from numpy frames through "
        "patchify_qwen_vl")
    arr = (pixels.astype(np.float32) / 255.0 - image.OPENAI_CLIP_MEAN) \
        / image.OPENAI_CLIP_STD
    return image.patchify_qwen_vl(arr.transpose(2, 0, 1)[None],
                                  processing.get("patch_size", 14))


def _vl_request(cfg, side: int, seed: int, n_pre: int = 12, n_post: int = 20):
    """Prompt ids with one image of `side` pixels, its host inputs (numpy)
    and its content digest."""
    from aha_tpu_torch.models.qwen2_5vl_served import build_mm, mm_digest

    patches, grid = _vl_image(side, seed)
    rng = np.random.default_rng(seed)
    n_units = grid[0] * grid[1] * grid[2] // 4
    ids = (_prompt(rng, n_pre, 151643) + [VL_VSTART] + [VL_IMAGE] * n_units
           + [VL_VEND] + _prompt(rng, n_post, 151643))
    return (ids, build_mm([patches], [grid], ids, cfg), patches, grid,
            mm_digest([patches], [grid]))


def teacher_forced_vl(model, params, ids, mm, forced, device):
    """Prefill `ids` with the image inputs `mm`, then feed `forced` one
    token per step; the (1 + len(forced), H) final hidden states in f32 on
    the CPU."""
    from aha_tpu_torch.core import cache as kv
    from aha_tpu_torch.core.engine import bucket_for

    rows = max(1024, bucket_for(len(ids) + len(forced)))
    cache = model.init_cache(1, rows, embed_dtype(params))
    x = torch.zeros((1, bucket_for(len(ids))), dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    hs = [model.backbone(params, x.to(device), cache, mm=mm,
                         prompt_len=len(ids))[0, len(ids) - 1]]
    kv.advance(cache, len(ids))
    for t in forced:
        hs.append(model.backbone(params, torch.tensor([[t]], device=device),
                                 cache)[0, 0])
        kv.advance(cache, 1)
    return torch.stack(hs).float().cpu()


def embed_dtype(params: dict) -> torch.dtype:
    """The embedding's dtype: a VL tree's text decoder's, or a decoder
    tree's own (Qwen3.5 with its tower)."""
    return params.get("text", params)["embed"]["w"].dtype


def _vl_run(ids, mm, key, cfg, n: int = 32):
    """`run` for eager_twin: one request of `n` tokens with its images or
    video."""
    def run(eng):
        out = eng.generate_tokens(ids, cfg, max_tokens=n, mm=mm, mm_key=key,
                                  mm_token_ids=(VL_IMAGE, VL_VIDEO))
        return [out], [eng.last_timing]

    return run


def phase_vl(device: str = "cuda") -> dict:
    """(n1)-(n3) at the published geometry, then the teacher-forced check
    at reduced depth; returns the model and parameters."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import (Qwen2_5VLModel, mm_to,
                                                qwen2_5vl_3b)

    cfg = qwen2_5vl_3b()
    model = Qwen2_5VLModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(3),
                               dtype=torch.bfloat16)
    fused = model.fuse_params(params)
    _sync(device)
    n_vis = sum(t.numel() for t in _leaves(params["visual"]))
    n_text = sum(t.numel() for name, t in params["text"].items()
                 if name != "lm_head" for t in _leaves(t))
    log(f"[vl] Qwen2.5-VL-3B geometry: vision {cfg.vision.depth} blocks H="
        f"{cfg.vision.hidden_size}, text {cfg.text.num_hidden_layers} layers "
        f"H={cfg.text.hidden_size} V={cfg.text.vocab_size} tied: "
        f"{n_vis / 1e6:.1f} M + {n_text / 1e6:.1f} M bf16 params seeded on "
        f"the card in {time.perf_counter() - t0:.1f} s (set-up)")
    greedy = SamplingConfig()
    reqs = {"n1": _vl_request(cfg, 448, 1), "n2": _vl_request(cfg, 980, 2)}
    for name, side, patches in (("n1", 448, 1024), ("n2", 980, 4900)):
        ids, mm_np, pat, grid, _ = reqs[name]
        require(pat.shape[0] == patches and ids.count(VL_IMAGE) == patches // 4,
                f"({name}) {side} px: {pat.shape[0]} patches, grid {grid}")
    mms = {name: mm_to(r[1], torch.device(device)) for name, r in reqs.items()}

    # warm-up of both patch buckets and prompt buckets, not counted; then
    # the vision tower alone per image
    warm = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    for name, r in reqs.items():
        warm.generate_tokens(r[0], greedy, max_tokens=4, mm=mms[name])
    del warm
    vision_ms = {}
    with torch.no_grad():
        for name in reqs:
            _sync(device)
            t0 = time.perf_counter()
            model.encode_vision(params["visual"], mms[name])
            _sync(device)
            vision_ms[name] = (time.perf_counter() - t0) * 1e3

    eng = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                     prefix_cache_entries=4)
    outs, timing, counts = {}, {}, {}
    steps = 32                  # 2 decode blocks of 16 for 32 tokens
    for name in ("n1", "n2"):
        ids, _, _, _, key = reqs[name]
        wr = zero_counts()
        _sync(device)
        outs[name] = eng.generate_tokens(ids, greedy, max_tokens=32,
                                         mm=mms[name], mm_key=key,
                                         mm_token_ids=(VL_IMAGE,))
        _sync(device)
        timing[name] = eng.last_timing
        got = counts[name] = read_counts(
            wr, f"vl-{name}", ("flash_attention_segmented", "flash_attention",
                               "flash_decode_at_layer"))
        require(got["flash_attention_segmented"] == 32
                and got["flash_attention"] == 36
                and got["flash_decode_at_layer"] == 36 * steps,
                f"({name}) launches {got}")
        RESULTS["flash_decode"]["launches"] = got["flash_decode"]
    # (n3): a follow-up turn on (n2)'s image — the stored prompt and more
    # text: the prefix store restores its rows and rope_delta, the suffix
    # is prefilled at its offset and no vision block runs
    ids2, _, pat2, grid2, key2 = reqs["n2"]
    rng = np.random.default_rng(33)
    ids3 = ids2 + _prompt(rng, 24, 151643)
    from aha_tpu_torch.models.qwen2_5vl_served import build_mm

    mm3 = mm_to(build_mm([pat2], [grid2], ids3, cfg), torch.device(device))
    wr = zero_counts()
    _sync(device)
    outs["n3"] = eng.generate_tokens(ids3, greedy, max_tokens=32, mm=mm3,
                                     mm_key=key2, mm_token_ids=(VL_IMAGE,))
    _sync(device)
    timing["n3"] = eng.last_timing
    got = counts["n3"] = read_counts(wr, "vl-n3", ("flash_decode_at_layer",))
    require(got["flash_attention_segmented"] == 0
            and got["flash_attention"] == 0
            and got["flash_decode_at_layer"] == 36 * steps,
            f"(n3) was not a prefix-store hit: launches {got}")
    for name, out in outs.items():
        require(len(out) == 32 and all(0 <= t < cfg.text.vocab_size
                                       for t in out),
                f"({name}): {len(out)} tokens")
    card = card_line() if device == "cuda" else "cpu"
    for name, what in (("n1", "448 x 448 image, 1024 patches (bucket 1024)"),
                       ("n2", "980 x 980 image, 4900 patches (bucket 6400)"),
                       ("n3", "follow-up on (n2), prefix-store hit")):
        t = timing[name]
        vis = (f"; vision tower alone {vision_ms[name]:.2f} ms"
               if name in vision_ms else "")
        log(f"[vl] ({name}) {what}: {t.prompt_tokens}-token prompt, prefill "
            f"(vision + text, first token read) {t.prompt_secs * 1e3:.2f} ms"
            f"{vis}; 32 greedy tokens, decode "
            f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s at "
            f"batch 1 (per-op chain) | {card}")
    # each of (n1)-(n3) once more through an eager engine with its own
    # prefix store, request by request
    eager = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                       prefix_cache_entries=4, cuda_graphs=False)
    vl_reqs = {"n1": (reqs["n1"][0], mms["n1"], reqs["n1"][4]),
               "n2": (reqs["n2"][0], mms["n2"], key2),
               "n3": (ids3, mm3, key2)}
    for name, (ids, mm, key) in vl_reqs.items():
        eager_twin(f"(n) Qwen2.5-VL-3B ({name})", eng, lambda: eager,
                   _vl_run(ids, mm, key, greedy), [outs[name]], counts[name],
                   device)
    cold = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    out3_cold = cold.generate_tokens(ids3, greedy, max_tokens=32, mm=mm3)
    same = next((i for i, (x, y) in enumerate(zip(outs["n3"], out3_cold))
                 if x != y), 32)
    log(f"[vl] (n3) against a cold engine's full prefill of the same prompt "
        f"(kernel prefill vs the plain suffix prefill over restored rows): "
        f"greedy streams equal for the first {same}/32 tokens")
    del cold, eng, fused
    if device == "cuda":
        torch.cuda.empty_cache()

    # 8 teacher-forced steps at reduced depth: the card through the kernels
    # against the CPU in f32 through the plain versions
    cut = qwen2_5vl_3b(**VL_CUT)
    small = Qwen2_5VLModel(cut, max_rope_len=8192, device=device)
    sp = _vl_cut(params, VL_CUT["depth"], VL_CUT["layers"])
    ids1, mm1_np = reqs["n1"][0], reqs["n1"][1]
    forced = outs["n1"][:8]
    wr = zero_counts()
    hk = teacher_forced_vl(small, sp, ids1, mms["n1"], forced, device)
    launches = {n: fn.launches for n, fn in wr.items()}
    require(launches["flash_attention_segmented"] == VL_CUT["depth"]
            and launches["flash_decode_at_layer"] == 8 * VL_CUT["layers"],
            f"teacher-forced launches {launches}")
    cpu_model = Qwen2_5VLModel(cut, max_rope_len=8192, device="cpu")
    cpu_params = _tree_to({"visual": sp["visual"],
                           "text": {k: v for k, v in sp["text"].items()
                                    if k != "lm_head"}}, "cpu", torch.float32)
    cpu_params["text"]["lm_head"] = {"w": cpu_params["text"]["embed"]["w"]}
    hp = teacher_forced_vl(cpu_model, cpu_params, ids1,
                           mm_to(mm1_np, torch.device("cpu")), forced, "cpu")
    rel = ((hk - hp).abs().max() / hp.abs().max()).item()
    by_pos = " ".join(f"{((hk[i] - hp[i]).abs().max() / hp.abs().max()).item():.1e}"
                      for i in range(len(hk)))
    log(f"[vl] teacher-forced (n1) at full width, {VL_CUT['depth']} vision "
        f"blocks (block 7 full-attention) and {VL_CUT['layers']} text "
        f"layers, 9 positions: hidden max err {rel:.3e} of max |ref| (tol "
        f"{TOL_VL_HIDDEN_REL}; by position {by_pos})")
    require(rel <= TOL_VL_HIDDEN_REL, f"VL hidden off by {rel}")
    del cpu_params, cpu_model
    return {"model": model, "params": params}


def phase_http_vl(params: dict, vl3: dict) -> None:
    """The reduced-depth models served by `python -m aha_tpu_torch serv
    <dir>` in child processes: Qwen2.5-VL (VL_CUT; model type read from
    its config.json) answering an image, a video and a text chat, graphed
    and --eager with equal replies; then phase_vl3's cut Qwen3-VL (its
    config.json's model type qwen3_vl: Qwen/Qwen3-VL-8B-Instruct) answering
    an image, a video and a text chat, and the cut Qwen3.5 with the tower
    served as Qwen/Qwen3.5-0.8B answering an image chat."""
    with contextlib.ExitStack() as stack:
        tmp, tmp3, tmp35 = (stack.enter_context(tempfile.TemporaryDirectory(
            prefix=f"aha_torch_{kind}_")) for kind in ("vl", "vl3", "q35vl"))
        _write_vl_checkpoint(tmp, params)
        _write_vl3_checkpoint(tmp3, "qwen3vl", vl3["qwen3vl"])
        _write_vl3_checkpoint(tmp35, "qwen3_5", vl3["qwen3_5"])
        with _servers((tmp, ()), (tmp, ("--eager",)), (tmp3, ()),
                      (tmp35, ("--model", "Qwen/Qwen3.5-0.8B"))) as bases:
            replies = _ask_vl(bases[0])
            _same_replies("Qwen2.5-VL", replies, _ask_vl(bases[1]))
            _ask_vl3(bases[2], "Qwen/Qwen3-VL-8B-Instruct", video=True)
            _ask_vl3(bases[3], "Qwen/Qwen3.5-0.8B", video=False)


def _write_vl_checkpoint(tmp: str, params: dict) -> None:
    """A servable Qwen2.5-VL directory: the test tokenizer with the four
    vision special tokens and a chat template with image and video parts,
    an HF-style config at the published widths and VL_CUT's depth whose
    vision ids are that tokenizer's, and the seeded weights (embedding
    rows past the tokenizer zeroed, so replies decode to text)."""
    from aha_tpu_torch.io.weights import save_hf_qwen2_5vl
    from aha_tpu_torch.models.qwen2_5vl import qwen2_5vl_3b

    tok, ids = _vl_tokenizer(tmp)
    cut = _vl_cut(params, VL_CUT["depth"], VL_CUT["layers"])
    cut["text"] = _text_rows_zeroed(cut["text"],
                                    tok.get_vocab_size(with_added_tokens=True))
    model_cfg = qwen2_5vl_3b(**VL_CUT)
    v = model_cfg.vision
    cfg = {**model_cfg.text.__dict__,
           "architectures": ["Qwen2_5_VLForConditionalGeneration"],
           "model_type": "qwen2_5_vl", "torch_dtype": "bfloat16",
           "rope_scaling": {"type": "mrope", "mrope_section":
                            list(model_cfg.mrope_section)},
           "vision_config": {**v.__dict__, "fullatt_block_indexes":
                             list(v.fullatt_block_indexes)}, **ids}
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    save_hf_qwen2_5vl(cut, tmp)
    log(f"[vl-http] full-width checkpoint ({VL_CUT['depth']} vision blocks, "
        f"{VL_CUT['layers']} text layers) written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")


# -- 8b. Qwen3-VL and Qwen3.5 with the deepstack tower (w, x) ---------------

#: (w)'s and (x)'s teacher-forced depth, and the served checkpoints': 4
#: vision blocks with deepstack after blocks 1, 2 and 3, 4 text layers, at
#: the published widths
VL3_CUT = dict(depth=4, layers=4, deepstack=(1, 2, 3))
#: per path: TTFT (prefill with the tower, first token read), the tower
#: alone and decode ms/step graphed and eager (one JSON line before the
#: kernels line)
VL3_READINGS: dict[str, dict] = {}


def _vl3_image_request(cfg, side: int, seed: int, n_pre: int = 12,
                       n_post: int = 20):
    """Prompt ids with one image of `side` pixels through Qwen3-VL's
    processing (patch 16, its pixel bounds), the host inputs (numpy) and
    the content digest."""
    from aha_tpu_torch.models import qwen3vl_served as served

    patches, grid = _vl_image(side, seed, patch_size=16,
                              min_pixels=served.MIN_PIXELS,
                              max_pixels=served.MAX_PIXELS)
    rng = np.random.default_rng(seed)
    n_units = grid[0] * grid[1] * grid[2] // 4
    ids = (_prompt(rng, n_pre, 151643) + [VL_VSTART] + [VL_IMAGE] * n_units
           + [VL_VEND] + _prompt(rng, n_post, 151643))
    return {"ids": ids, "mm": served.build_mm([patches], [grid], ids, cfg),
            "patches": patches, "grids": [grid],
            "key": served.mm_digest([patches], [grid])}


def _npz_data_url(n: int, side: int, fps: float, seed: int) -> str:
    """A data URL of an .npz holding n seeded side x side RGB frames and
    their fps."""
    import base64
    import io

    buf = io.BytesIO()
    np.savez(buf, frames=np.random.default_rng(seed).integers(
        0, 255, (n, side, side, 3), dtype=np.uint8), fps=fps)
    return ("data:application/octet-stream;base64,"
            + base64.b64encode(buf.getvalue()).decode())


def _vl3_video_request(cfg, seed: int, n: int = 8, side: int = 448,
                       fps: float = 2.0):
    """(w2): an n-frame `side`-pixel .npz at `fps` through the port's video
    processing (load, 2 fps sampling, resize, temporal patchify), laid out
    as the served model lays it out — each temporal pair its own vision
    block after its timestamp, 5 seeded text ids standing for the
    "<t seconds>" text the tokenizer would give — with its per-frame
    grids."""
    from aha_tpu_torch.models import qwen3vl_served as served
    from aha_tpu_torch.utils import video

    frames, src_fps = video.load_video_frames(
        _npz_data_url(n, side, fps, seed))
    frames, idx, fps = video.sample_frames(frames, src_fps, 2.0, 4, 64)
    patches, grid = video.preprocess_video_qwen_vl(
        frames, 16, 2, 2, served.MIN_PIXELS, served.MAX_PIXELS * 4)
    stamps = [float(t) for t in video.video_timestamps(idx, fps, 2)]
    rng = np.random.default_rng(seed)
    per_frame = grid[1] * grid[2] // 4
    ids = _prompt(rng, 12, 151643)
    for _ in range(grid[0]):
        ids += (_prompt(rng, 5, 151643) + [VL_VSTART]
                + [VL_VIDEO] * per_frame + [VL_VEND])
    ids += _prompt(rng, 20, 151643)
    grids = [(1, grid[1], grid[2])] * grid[0]
    return {"ids": ids, "mm": served.build_mm([patches], grids, ids, cfg),
            "patches": patches, "grids": grids, "grid": grid,
            "stamps": stamps, "key": served.mm_digest([patches], grids)}


def _wall_ms(fn, device: str) -> float:
    """Wall ms of one call of `fn` (after a warm-up call)."""
    with torch.no_grad():
        fn()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
    return (time.perf_counter() - t0) * 1e3


def _tower_ms(model, visual: dict, mm: dict, device: str) -> float:
    """Wall ms of the tower alone on one request's inputs (after a
    warm-up)."""
    return _wall_ms(lambda: model.tower.encode(visual, mm), device)


def _vl3_teacher_forced(tag: str, model_cls, cut_cfg, small_params: dict,
                        req: dict, forced: list[int], device: str,
                        launches: dict, phase: str = "vl3",
                        cut: str | None = None, **model_kw) -> None:
    """8 teacher-forced steps of the cut model (`cut` says how it was cut;
    VL3_CUT's words by default): the card through the kernels against the
    CPU in f32 through the plain versions; the card's run must launch
    `launches` (name → count)."""
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    small = model_cls(cut_cfg, max_rope_len=8192, device=device, **model_kw)
    wr = zero_counts()
    hk = teacher_forced_vl(small, small_params, req["ids"],
                           mm_to(req["mm"], torch.device(device)), forced,
                           device)
    got = {n: fn.launches for n, fn in wr.items()}
    require(device != "cuda" or all(got[n] == c for n, c in launches.items()),
            f"({tag}) teacher-forced launches {got}, want {launches}")
    cpu_model = model_cls(cut_cfg, max_rope_len=8192, device="cpu",
                          **model_kw)
    # the backbone reads no head: leave it on the card
    text = small_params.get("text", small_params)
    text = {k: v for k, v in text.items() if k != "lm_head"}
    cpu_params = _tree_to({**small_params, "text": text}
                          if "text" in small_params else text,
                          "cpu", torch.float32)
    hp = teacher_forced_vl(cpu_model, cpu_params, req["ids"],
                           mm_to(req["mm"], torch.device("cpu")), forced,
                           "cpu")
    rel = ((hk - hp).abs().max() / hp.abs().max()).item()
    by_pos = " ".join(
        f"{((hk[i] - hp[i]).abs().max() / hp.abs().max()).item():.1e}"
        for i in range(len(hk)))
    cut = cut or (f"{VL3_CUT['depth']} vision blocks (deepstack after 1, "
                  f"2, 3) and {VL3_CUT['layers']} text layers")
    log(f"[{phase}] ({tag}) teacher-forced at full width, {cut}, 9 "
        f"positions: hidden max err {rel:.3e} of max |ref| (tol "
        f"{TOL_VL_HIDDEN_REL}; by position {by_pos})")
    require(rel <= TOL_VL_HIDDEN_REL, f"({tag}) hidden off by {rel}")


def _vl3_path(tag: str, what: str, eng, eager, req: dict, greedy,
              must: tuple[str, ...], want: dict, device: str,
              tower: float | None = None, n: int = 32,
              phase: str = "vl3", readings: dict | None = None
              ) -> list[int]:
    """One request of `n` greedy tokens through the graphed engine (counts
    zeroed before it, each of `want` required equal), then eager_twin;
    TTFT and decode ms/step into `readings` (VL3_READINGS by default).
    Returns the tokens."""
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    if "mm_dev" not in req:                 # None for a text-only request
        req["mm_dev"] = (None if req.get("mm") is None
                         else mm_to(req["mm"], torch.device(device)))
    mm = req["mm_dev"]
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(req["ids"], greedy, max_tokens=n, mm=mm,
                              mm_key=req.get("key"),
                              mm_token_ids=(VL_IMAGE, VL_VIDEO))
    _sync(device)
    t = eng.last_timing
    counts = read_counts(wr, f"{phase}-{tag}", must)
    require(device != "cuda" or all(counts[k] == c for k, c in want.items()),
            f"({tag}) launches {counts}, want {want}")
    require(len(out) == n, f"({tag}): {len(out)} tokens")
    card = card_line() if device == "cuda" else "cpu"
    ttft = t.prompt_secs * 1e3
    log(f"[{phase}] ({tag}) {what}: {t.prompt_tokens}-token prompt, TTFT "
        f"(tower + prefill, first token read) {ttft:.2f} ms"
        + (f"; tower alone {tower:.2f} ms" if tower is not None else "")
        + f"; {n} greedy tokens, decode "
        f"{(t.completion_tokens - 1) / t.completion_secs:.1f} tok/s | {card}")
    eager_twin(f"({tag}) {what}", eng, lambda: eager,
               _vl_run(req["ids"], mm, req.get("key"), greedy, n), [out],
               counts, device)
    g = GRAPH_READINGS[-1]
    (VL3_READINGS if readings is None else readings)[tag] = {
        "what": what, "prompt_tokens": t.prompt_tokens, "ttft_ms": ttft,
        "tower_ms": tower,
        "decode_ms_per_step_graphed": g["ms_per_step_graphed"],
        "decode_ms_per_step_eager": g["ms_per_step_eager"], "card": card}
    return out


def phase_vl3(device: str = "cuda") -> dict:
    """(w) Qwen3-VL-8B-Instruct's published geometry and (x) Qwen3.5 with
    the Qwen3-VL tower, seeded bf16 weights on the card, through TextEngine;
    each then teacher-forced at reduced depth against the CPU.  Returns the
    two reduced-depth parameter trees (copies: the full weights are freed
    here) for the HTTP phase."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.qwen2_5vl import mm_to
    from aha_tpu_torch.models.qwen3_5 import Qwen3_5Model, qwen3_5_vl_default
    from aha_tpu_torch.models.qwen3vl import Qwen3VLModel, qwen3vl_8b

    greedy = SamplingConfig()
    card = card_line() if device == "cuda" else "cpu"
    # (w) -------------------------------------------------------------------
    cfg = qwen3vl_8b()
    require(cfg.vision.head_dim == 72, "the tower's heads are not 72 wide")
    model = Qwen3VLModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(8),
                               dtype=torch.bfloat16)
    fused = model.fuse_params(params)
    _sync(device)
    n_vis = sum(t.numel() for t in _leaves(params["visual"]))
    n_text = sum(t.numel() for t in _leaves(params["text"]))
    log(f"[vl3] (w) Qwen3-VL-8B geometry: tower {cfg.vision.depth} blocks "
        f"H={cfg.vision.hidden_size} (16 heads of 72, deepstack after 8, 16, "
        f"24), text {cfg.text.num_hidden_layers} layers "
        f"H={cfg.text.hidden_size} 32/8 heads V={cfg.text.vocab_size} "
        f"untied: {n_vis / 1e6:.1f} M + {n_text / 1e6:.1f} M bf16 params "
        f"seeded on the card in {time.perf_counter() - t0:.1f} s (set-up)")
    reqs = {"w1": _vl3_image_request(cfg, 1024, 1),
            "w2": _vl3_video_request(cfg, 2)}
    w1, w2 = reqs["w1"], reqs["w2"]
    require(w1["patches"].shape[0] == 4096
            and w1["ids"].count(VL_IMAGE) == 1024,
            f"(w1) 1024 px: {w1['patches'].shape[0]} patches")
    require(tuple(w2["grid"]) == (4, 28, 28)
            and w2["ids"].count(VL_VIDEO) == 784
            and w2["mm"]["patches"].shape[0] == VL3_BUCKET,
            f"(w2) video grid {w2['grid']}")
    log(f"[vl3] (w2) video: 8 frames of 448 x 448 at 2 fps, grid "
        f"{tuple(w2['grid'])}, timestamps {w2['stamps']}, 784 video tokens, "
        f"{w2['patches'].shape[0]} patches in the {VL3_BUCKET} bucket")
    # (w3): a follow-up turn on (w1)'s image, restored from the store
    rng = np.random.default_rng(33)
    ids3 = w1["ids"] + _prompt(rng, 24, 151643)
    from aha_tpu_torch.models.qwen3vl_served import build_mm

    reqs["w3"] = {"ids": ids3, "key": w1["key"],
                  "mm": build_mm([w1["patches"]], w1["grids"], ids3, cfg)}
    # warm-up of the patch and prompt buckets, not counted
    warm = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    for name in ("w1", "w2"):
        warm.generate_tokens(reqs[name]["ids"], greedy, max_tokens=4,
                             mm=mm_to(reqs[name]["mm"], torch.device(device)))
    del warm
    eng = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                     prefix_cache_entries=4)
    eager = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                       prefix_cache_entries=4, cuda_graphs=False)
    L = cfg.text.num_hidden_layers
    must = ("flash_attention_segmented", "flash_attention",
            "flash_decode_at_layer_flat", "head_argmax")
    full = {"flash_attention_segmented": cfg.vision.depth,
            "flash_attention": L, "flash_decode_at_layer_flat": L * 32,
            "head_argmax": 32, "fused_decode_stack": 0}
    outs = {}
    for name, what in (("w1", "1024 x 1024 image, 4096 patches, 1024 image "
                               "tokens"),
                       ("w2", "8-frame 448 x 448 .npz video at 2 fps, 784 "
                              "video tokens")):
        mm = mm_to(reqs[name]["mm"], torch.device(device))
        tower = _tower_ms(model, params["visual"], mm, device)
        reqs[name]["mm_dev"] = mm
        outs[name] = _vl3_path(name, what, eng, eager, reqs[name], greedy,
                               must, full, device, tower)
    entry, p3 = eng._prefix_entries.match(ids3, w1["key"])
    require(entry is not None and p3 == len(w1["ids"])
            and "rope_delta" in entry,
            f"(w3) the follow-up restores from {p3}, not (w1)'s prompt")
    outs["w3"] = _vl3_path(
        "w3", "follow-up on (w1)'s image, prefix-store hit", eng, eager,
        reqs["w3"], greedy, ("flash_decode_at_layer_flat", "head_argmax"),
        {"flash_attention_segmented": 0, "flash_attention": 0,
         "flash_decode_at_layer_flat": L * 32}, device)
    # the restore itself at full width: the suffix over the stored rows and
    # rope_delta against a cold prefill of the whole prompt with its image
    VL3_READINGS["w3"]["restore"] = _restore_check(
        "w3", model, fused, ids3, entry, p3, outs["w3"][:8], device,
        mm=reqs["w3"]["mm_dev"],
        drop=("rope_delta",), dropped="rope_delta", label="(w3)",
        phase="vl3")
    del entry
    log(f"[vl3] (w) every segment call of the path is the tower's, 16 heads "
        f"of 72: {cfg.vision.depth} a request with vision; decode runs the "
        f"per-op layers (flash_decode_at_layer_flat {L} a step, head_argmax "
        f"over the untied 4096 x 151936 head), never the fused stack | "
        f"{card}")
    del eng, eager, fused
    if device == "cuda":
        torch.cuda.empty_cache()
    # reduced depth, teacher-forced, on a 224 x 224 image
    cut_cfg = qwen3vl_8b(**VL3_CUT)
    text = params["text"]
    small = {"visual": {**params["visual"],
                        "blocks": params["visual"]["blocks"][:VL3_CUT["depth"]]},
             "text": {**text, "layers": _tree_map(
                 lambda t: t[:VL3_CUT["layers"]].clone(), text["layers"])}}
    del params, text, model
    if device == "cuda":
        torch.cuda.empty_cache()
    req_tf = _vl3_image_request(cut_cfg, 224, 4)
    _vl3_teacher_forced(
        "w", Qwen3VLModel, cut_cfg, small, req_tf, outs["w1"][:8], device,
        {"flash_attention_segmented": VL3_CUT["depth"],
         "flash_decode_at_layer_flat": 8 * VL3_CUT["layers"]})

    # (x) -------------------------------------------------------------------
    xcfg = qwen3_5_vl_default()
    xm = Qwen3_5Model(xcfg.text, max_rope_len=8192, device=device,
                      vl_config=xcfg)
    xp = xm.init_random(torch.Generator(device=device).manual_seed(9),
                        dtype=torch.bfloat16)
    xfused = xm.fuse_params(xp)
    req_x = _vl3_image_request(xcfg, 448, 5)
    require(req_x["patches"].shape[0] == 784, "(x) 448 px: "
            f"{req_x['patches'].shape[0]} patches")
    warm = TextEngine(xm, xfused, eos_token_ids=[], max_seq_len=8192)
    warm.generate_tokens(req_x["ids"], greedy, max_tokens=4,
                         mm=mm_to(req_x["mm"], torch.device(device)))
    del warm
    xeng = TextEngine(xm, xfused, eos_token_ids=[], max_seq_len=8192)
    xeager = TextEngine(xm, xfused, eos_token_ids=[], max_seq_len=8192,
                        cuda_graphs=False)
    mm = mm_to(req_x["mm"], torch.device(device))
    req_x["mm_dev"] = mm
    n_attn = xm.n_attn
    outs["x"] = _vl3_path(
        "x", "Qwen3.5 (24 layers, hidden 1024) + the 27-block tower, 448 x "
             "448 image, 196 image tokens", xeng, xeager, req_x, greedy,
        ("flash_attention_segmented", "flash_attention",
         "flash_decode_at_layer"),
        {"flash_attention_segmented": xcfg.vision.depth,
         "flash_attention": n_attn, "flash_decode_at_layer": n_attn * 32},
        device, _tower_ms(xm, xp["visual"], mm, device))
    del xeng, xeager, xfused
    xcut = qwen3_5_vl_default(layers=VL3_CUT["layers"],
                              depth=VL3_CUT["depth"],
                              deepstack=VL3_CUT["deepstack"])
    xsmall = {**xp, "layers": xp["layers"][:VL3_CUT["layers"]],
              "visual": {**xp["visual"],
                         "blocks": xp["visual"]["blocks"][:VL3_CUT["depth"]]}}
    n_cut_attn = sum(t == "full_attention" for t in xcut.text.layer_types)
    _vl3_teacher_forced(
        "x", lambda c, **kw: Qwen3_5Model(c.text, vl_config=c, **kw), xcut,
        xsmall, _vl3_image_request(xcut, 224, 6), outs["x"][:8], device,
        {"flash_attention_segmented": VL3_CUT["depth"],
         "flash_decode_at_layer": 8 * n_cut_attn})
    del xp, xm
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"qwen3vl": small, "qwen3_5": xsmall}


#: the chat template's content loop, rendering image and video parts
VL_TEMPLATE_PARTS = (
    "{% if message.content is string %}{{ message.content }}"
    "{% else %}{% for part in message.content %}"
    "{% if part.type == 'text' %}{{ part.text }}"
    "{% elif part.type == 'image_url' %}"
    "<|vision_start|><|image_pad|><|vision_end|>"
    "{% elif part.type == 'video_url' %}"
    "<|vision_start|><|video_pad|><|vision_end|>{% endif %}"
    "{% endfor %}{% endif %}")


def _vl_tokenizer(tmp: str) -> tuple:
    """The test tokenizer with the four vision special tokens, its chat
    template with image and video parts and generation config written to
    `tmp`; (tokenizer, the config.json token fields)."""
    from tokenizers import AddedToken

    fixtures, tok = _smoke_tokenizer(tmp)
    tok.add_special_tokens([AddedToken(t, special=True) for t in
                            ("<|vision_start|>", "<|image_pad|>",
                             "<|vision_end|>", "<|video_pad|>")])
    tok.save(os.path.join(tmp, "tokenizer.json"))
    eos = tok.token_to_id("<|im_end|>")
    with open(os.path.join(tmp, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": [eos]}, f)
    with open(os.path.join(tmp, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": fixtures.CHAT_TEMPLATE.replace(
            "{{ message.content }}", VL_TEMPLATE_PARTS)}, f)
    return tok, {"image_token_id": tok.token_to_id("<|image_pad|>"),
                 "video_token_id": tok.token_to_id("<|video_pad|>"),
                 "vision_start_token_id": tok.token_to_id("<|vision_start|>"),
                 "vision_end_token_id": tok.token_to_id("<|vision_end|>"),
                 "eos_token_id": eos}


def _text_rows_zeroed(tree: dict, vocab: int) -> dict:
    """The embedding (and an untied head) with the rows past the test
    tokenizer's vocabulary zeroed, so replies decode to text."""
    embed = tree["embed"]["w"].clone()
    embed[vocab:] = 0
    head = tree["lm_head"]["w"]
    if head is tree["embed"]["w"]:
        head = embed
    else:
        head = head.clone()
        head[vocab:] = 0
    return {**tree, "embed": {"w": embed}, "lm_head": {"w": head}}


def _vision_json(v) -> dict:
    return {**v.__dict__, "deepstack_visual_indexes":
            list(v.deepstack_visual_indexes)}


def _write_vl3_checkpoint(tmp: str, kind: str, params: dict) -> None:
    """A servable reduced-depth (VL3_CUT) directory at the published
    widths: "qwen3vl" as a Qwen3VLForConditionalGeneration checkpoint
    (model_type qwen3_vl), "qwen3_5" as a Qwen3.5 one with a vision tower;
    the test tokenizer's vision ids in config.json."""
    from aha_tpu_torch.io import weights
    from aha_tpu_torch.models.qwen3_5 import qwen3_5_vl_default
    from aha_tpu_torch.models.qwen3vl import qwen3vl_8b

    tok, ids = _vl_tokenizer(tmp)
    vocab = tok.get_vocab_size(with_added_tokens=True)
    t0 = time.perf_counter()
    if kind == "qwen3vl":
        c = qwen3vl_8b(**VL3_CUT)
        cfg = {"architectures": ["Qwen3VLForConditionalGeneration"],
               "model_type": "qwen3_vl", "torch_dtype": "bfloat16",
               "text_config": {**c.text.__dict__, "rope_scaling": {
                   "rope_type": "default", "mrope_interleaved": True,
                   "mrope_section": list(c.mrope_section)}},
               "vision_config": _vision_json(c.vision), **ids}
        weights.save_hf_qwen3vl({**params, "text": _text_rows_zeroed(
            params["text"], vocab)}, tmp)
    else:
        c = qwen3_5_vl_default(layers=VL3_CUT["layers"],
                               depth=VL3_CUT["depth"],
                               deepstack=VL3_CUT["deepstack"])
        cfg = {"architectures": ["Qwen3_5ForConditionalGeneration"],
               "model_type": "qwen3_5", "torch_dtype": "bfloat16",
               "text_config": {**c.text.__dict__,
                               "layer_types": list(c.text.layer_types)},
               "vision_config": _vision_json(c.vision), **ids}
        weights.save_hf_qwen3_5(_text_rows_zeroed(params, vocab), tmp,
                                prefix="model.language_model.")
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    log(f"[vl-http] {kind} full-width checkpoint ({VL3_CUT['depth']} vision "
        f"blocks, {VL3_CUT['layers']} text layers) written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")


def _vl_chat(base: str, model: str, content, what: str,
             min_prompt: int) -> str:
    """One greedy chat: 200, at least `min_prompt` prompt tokens, a reply;
    the reply's text."""
    status, text = _post(base + "/v1/chat/completions", {
        "model": model, "max_tokens": 16, "temperature": 0.0,
        "stream": False, "messages": [{"role": "user", "content": content}]})
    require(status == 200, f"{what}: {text[-500:]}")
    resp = json.loads(text)
    u, msg = resp["usage"], resp["choices"][0]["message"]
    require(u["prompt_tokens"] >= min_prompt and u["completion_tokens"] >= 1,
            f"{what}: usage {u}")
    log(f"[vl-http] {what} 200: usage prompt {u['prompt_tokens']} "
        f"completion {u['completion_tokens']}")
    return msg.get("content") or msg.get("reasoning_content") or ""


def _ask_vl3(base: str, model: str, video: bool) -> list[str]:
    """A 224 x 224 PNG image chat (49 image tokens), with `video` an
    8-frame 224 x 224 .npz chat at 2 fps (4 timestamped frames of 49
    tokens) and a text chat."""
    image = [{"type": "text", "text": "describe the image "},
             {"type": "image_url", "image_url": {"url": _png_data_url(224, 224, 7)}}]
    out = [_vl_chat(base, model, image, f"{model} image chat", 49)]
    if video:
        clip = [{"type": "text", "text": "what happens "},
                {"type": "video_url",
                 "video_url": {"url": _npz_data_url(8, 224, 2.0, 8)}}]
        out.append(_vl_chat(base, model, clip, f"{model} video chat", 196))
        out.append(_vl_chat(base, model, "hello world how are you today",
                            f"{model} text chat", 1))
    return out


def _png_data_url(w: int, h: int, seed: int) -> str:
    """A seeded w x h RGB image (`_rgb`) as a PNG data URL."""
    import base64
    import io

    buf = io.BytesIO()
    _rgb(w, h, seed).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _ask_vl(base: str) -> list[str]:
    """A 224 x 224 PNG image chat (256 patches, 64 image tokens), an
    8-frame 224 x 224 .npz video chat at 2 fps (grid (4, 16, 16): 256 video
    tokens) and a text-only chat: 200, the vision tokens in the prompt
    count, a reply; the three replies' texts."""
    model = "Qwen/Qwen2.5-VL-3B-Instruct"
    image = [{"type": "text", "text": "describe the image "},
             {"type": "image_url", "image_url": {"url": _png_data_url(224, 224, 7)}}]
    clip = [{"type": "text", "text": "what happens "},
            {"type": "video_url",
             "video_url": {"url": _npz_data_url(8, 224, 2.0, 8)}}]
    return [_vl_chat(base, model, image, "image chat", 64),
            _vl_chat(base, model, clip, "video chat", 256),
            _vl_chat(base, model, "hello world how are you today",
                     "text-only chat", 1)]


# -- 8c. the SigLIP-tower families: PaddleOCR-VL (y) and LFM2-VL (z) ---------

#: (y)'s and (z)'s teacher-forced depth, and the served checkpoints': 4
#: vision blocks and 4 text layers at the published widths
SIGLIP_CUT = dict(depth=4, layers=4)
#: greedy tokens a (y) / (z) request
SIGLIP_TOKENS = 64
#: per path: TTFT, the tower alone, decode ms/step graphed and eager; and
#: LFM2-VL's plain tower attention (one JSON line before the kernels line)
SIGLIP_READINGS: dict[str, dict] = {}
#: seeded ids standing for the task prompts' text ("OCR:", "Table
#: Recognition:"): no ERNIE tokenizer is in the repository
OCR_PROMPT_IDS = {"OCR:": [4101, 1562, 93], "Table Recognition:":
                  [8411, 30517, 93]}


def _rgb(w: int, h: int, seed: int):
    """A seeded random w x h RGB image (Pillow)."""
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (h, w, 3), dtype=np.uint8))


def _ocr_request(cfg, sizes: list[tuple[int, int]], task: str, seed: int):
    """(y): seeded images of `sizes` (w, h) through PaddleOCR-VL's served
    processing (factor-28 smart resize within 28² ... 28² · 4096 pixels,
    mean / std 0.5, row-major patches), each after its vision-start id
    with one image id a merge unit, then the task prompt's ids; the host
    inputs (numpy)."""
    from aha_tpu_torch.models.paddleocr_vl_served import build_mm
    from aha_tpu_torch.utils.image import preprocess_image_siglip

    rng = np.random.default_rng(seed)
    ids, patches, grids = _prompt(rng, 8, 100000), [], []
    for i, (w, h) in enumerate(sizes):
        p, grid = preprocess_image_siglip(_rgb(w, h, seed + i))
        patches.append(p)
        grids.append(grid)
        ids += ([cfg.vision_start_token_id]
                + [cfg.image_token_id] * (p.shape[0] // 4)
                + _prompt(rng, 1, 100000))
    ids += _prompt(rng, 4, 100000) + OCR_PROMPT_IDS[task]
    return {"ids": ids, "mm": build_mm(patches, grids, ids, cfg),
            "patches": patches, "grids": grids}


def phase_ocr(device: str = "cuda") -> dict:
    """(y) PaddleOCR-VL-0.9B's published geometry (tower 27 blocks at 1152,
    16 heads of 72; ERNIE-4.5-0.3B 18 layers at 1024, 16/2 heads of 128,
    vocab 103424, tied) with seeded bf16 weights on the card through
    TextEngine (no prefix store, as served): (y1) an A4 page at 150 dpi,
    (y2) two images in one request, (y3) a text-only follow-up; then 8
    teacher-forced steps of (y2) at SIGLIP_CUT against the CPU's f32 plain
    path.  Returns the cut parameters for the HTTP phase."""
    from aha_tpu_torch.core.engine import TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.paddleocr_vl import (PaddleOCRVLModel,
                                                   paddleocr_vl_0_9b)
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    greedy, n = SamplingConfig(), SIGLIP_TOKENS
    cfg = paddleocr_vl_0_9b()
    require(cfg.vision.head_dim == 72, "the tower's heads are not 72 wide")
    model = PaddleOCRVLModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(18),
                               dtype=torch.bfloat16)
    fused = model.fuse_params(params)
    _sync(device)
    n_vis = sum(t.numel() for t in _leaves(params["visual"]))
    n_text = sum(t.numel() for name, t in params["text"].items()
                 if name != "lm_head" for t in _leaves(t))
    log(f"[ocr] (y) PaddleOCR-VL-0.9B geometry: tower "
        f"{cfg.vision.num_hidden_layers} blocks H={cfg.vision.hidden_size} "
        f"(16 heads of 72), ERNIE-4.5-0.3B {cfg.text.num_hidden_layers} "
        f"layers H={cfg.text.hidden_size} 16/2 heads of 128 "
        f"V={cfg.text.vocab_size} tied: {n_vis / 1e6:.1f} M + "
        f"{n_text / 1e6:.1f} M bf16 params seeded on the card in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    reqs = {"y1": _ocr_request(cfg, [(1240, 1754)], "OCR:", 1),
            "y2": _ocr_request(cfg, [(448, 448), (672, 224)],
                               "Table Recognition:", 2)}
    y1, y2 = reqs["y1"], reqs["y2"]
    require(y1["patches"][0].shape[0] == PAGE_REAL
            and y1["mm"]["patches"].shape[0] == PAGE_BUCKET
            and y1["ids"].count(cfg.image_token_id) == PAGE_REAL // 4
            and bucket_for(len(y1["ids"])) == 4096,
            f"(y1) page: {y1['grids']}, {len(y1['ids'])} ids")
    require([p.shape[0] for p in y2["patches"]] == [1024, 768]
            and y2["mm"]["patches"].shape[0] == 2048
            and y2["ids"].count(cfg.image_token_id) == 448
            and bool((y2["mm"]["seg"][:1792] == 0).all()),
            f"(y2) two images: {y2['grids']}")
    rng = np.random.default_rng(3)
    reqs["y3"] = {"ids": _prompt(rng, 200, 100000), "mm": None}
    warm = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    for name in ("y1", "y2"):
        warm.generate_tokens(reqs[name]["ids"], greedy, max_tokens=4,
                             mm=mm_to(reqs[name]["mm"], torch.device(device)))
    del warm
    eng = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192)
    eager = TextEngine(model, fused, eos_token_ids=[], max_seq_len=8192,
                       cuda_graphs=False)
    L = cfg.text.num_hidden_layers
    must = ("flash_attention_segmented", "flash_attention",
            "flash_decode_at_layer")
    want = {"flash_attention_segmented": cfg.vision.num_hidden_layers,
            "flash_attention": L, "flash_decode_at_layer": L * n,
            "fused_decode_stack": 0, "flash_decode_at_layer_flat": 0}
    outs = {}
    for name, what in (("y1", "A4 page at 150 dpi, 11088 patches (bucket "
                               "16384), 2772 image tokens, OCR:"),
                       ("y2", "448 x 448 and 672 x 224 images in one "
                              "segment, 1792 patches (bucket 2048), 448 "
                              "image tokens, Table Recognition:")):
        mm = mm_to(reqs[name]["mm"], torch.device(device))
        reqs[name]["mm_dev"] = mm
        tower = _wall_ms(lambda: model.encode_vision(params["visual"], mm),
                         device)
        outs[name] = _vl3_path(name, what, eng, eager, reqs[name], greedy,
                               must, want, device, tower, n=n, phase="ocr",
                               readings=SIGLIP_READINGS)
    outs["y3"] = _vl3_path(
        "y3", "text-only follow-up, 200 tokens", eng, eager, reqs["y3"],
        greedy, ("flash_attention", "flash_decode_at_layer"),
        {**want, "flash_attention_segmented": 0}, device, n=n, phase="ocr",
        readings=SIGLIP_READINGS)
    card = card_line() if device == "cuda" else "cpu"
    log(f"[ocr] (y) every segment call is the tower's, 16 heads of 72 on "
        f"contiguous q/k/v: {cfg.vision.num_hidden_layers} a request with "
        f"images; the prefill kernel {L} a prefill of >= 128 rows; "
        f"flash_decode_at_layer {L} a step; never the fused stack | {card}")
    del eng, eager, fused
    if device == "cuda":
        torch.cuda.empty_cache()
    cut_cfg = paddleocr_vl_0_9b(**SIGLIP_CUT)
    text = params["text"]
    small = {"visual": {**params["visual"], "layers":
                        params["visual"]["layers"][:SIGLIP_CUT["depth"]]},
             "text": {**text, "layers": _tree_map(
                 lambda t: t[:SIGLIP_CUT["layers"]].clone(), text["layers"])}}
    del params, text, model
    if device == "cuda":
        torch.cuda.empty_cache()
    _vl3_teacher_forced(
        "y", PaddleOCRVLModel, cut_cfg, small, y2, outs["y2"][:8], device,
        {"flash_attention_segmented": SIGLIP_CUT["depth"],
         "flash_attention": SIGLIP_CUT["layers"],
         "flash_decode_at_layer": 8 * SIGLIP_CUT["layers"]}, phase="ocr",
        cut=f"{SIGLIP_CUT['depth']} vision blocks and "
            f"{SIGLIP_CUT['layers']} ERNIE layers, (y2)'s two images")
    return small


def _lfm2vl_request(cfg, table: np.ndarray, w: int, h: int, seed: int):
    """(z): a seeded w x h image through LFM2-VL's served processing (smart
    resize within 64 ... 256 tokens; past 2 x 256, 512-pixel tiles on the
    closest aspect grid and a thumbnail), its image ids (one a projected
    unit, tiles then the thumbnail) between seeded text ids; the host
    inputs (numpy)."""
    from aha_tpu_torch.models.lfm2vl_served import build_mm, resize_and_split

    entries, rows, cols, _ = resize_and_split(_rgb(w, h, seed), cfg, {})
    per = [p for p, _ in entries]
    shapes = [shape for _, shape in entries]
    units = sum((a // 2) * (b // 2) for a, b in shapes)
    rng = np.random.default_rng(seed)

    def text(k):                # ids past the image id (396)
        return [int(x) for x in rng.integers(400, 60000, k)]

    ids = text(12) + [cfg.image_token_id] * units + text(20)
    return {"ids": ids, "mm": build_mm(per, shapes, table, cfg),
            "shapes": shapes, "grid": (rows, cols), "units": units}


def _tower_attention_ms(cfg, mm: dict, device: str) -> dict:
    """LFM2-VL's tower attention (plain masked sdpa, as the reference
    computes it outside any Pallas kernel) at a request's packed batch:
    device ms of the port's call and of F.scaled_dot_product_attention
    with the same boolean mask, and the bound over the real pairs."""
    from aha_tpu_torch.ops.attention import sdpa

    mask = mm["pixel_mask"]
    B, N = mask.shape
    v = cfg.vision
    H, D = v.num_attention_heads, v.head_dim
    g = torch.Generator(device=device).manual_seed(7)
    q, k, val = (torch.randn((B, N, H, D), generator=g, device=device)
                 .bfloat16() for _ in range(3))
    m = mask[:, None, None, :]
    ms = device_ms(lambda: sdpa(q, k, val, m), iters=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, val))
    lib_ms = device_ms(lambda: _sdpa(qt, kt, vt, attn_mask=m), iters=10)
    real = mask.sum(1).double()
    b = bound(B * N * H * D * 2 * 4,
              float(4 * H * D * (real * real).sum().item()))
    return {"ms": ms, "library_ms": lib_ms, "bound_ms": b[0],
            "bound_by": b[1], "at": f"B={B} N={N} H={H} D={D}, "
            f"{int(real.sum().item())} real patches, boolean pixel mask"}


def phase_lfm2vl(device: str = "cuda") -> dict:
    """(z) LFM2-VL-1.6B's geometry (SigLIP2 so400m tower, 26 blocks at
    1152, 16 heads of 72, patch 16; projector 2560; LFM2-1.2B's decoder)
    with seeded bf16 weights on the card through TextEngine: (z1) an
    unsplit 512 x 512 image, (z2) a 1,536 x 1,024 image in 3 x 2 tiles
    and a thumbnail; the tower's plain attention timed; then 8
    teacher-forced steps of (z1) and of (z2) at SIGLIP_CUT against the
    CPU.  Returns
    the cut parameters for the HTTP phase."""
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.lfm2vl import Lfm2VLModel, lfm2vl_1_6b
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    greedy, n = SamplingConfig(), SIGLIP_TOKENS
    cfg = lfm2vl_1_6b()
    model = Lfm2VLModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(16),
                               dtype=torch.bfloat16)
    _sync(device)
    n_vis = sum(t.numel() for t in _leaves(params["visual"]))
    log(f"[lfm2vl] (z) LFM2-VL-1.6B geometry: tower "
        f"{cfg.vision.num_hidden_layers} blocks H={cfg.vision.hidden_size} "
        f"(16 heads of 72, patch 16), projector "
        f"{cfg.projector_hidden_size}, LFM2-1.2B decoder "
        f"{cfg.text.num_hidden_layers} layers: {n_vis / 1e6:.1f} M tower "
        f"params, all seeded bf16 on the card in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    table = params["visual"]["pos_table"].float().cpu().numpy()
    reqs = {"z1": _lfm2vl_request(cfg, table, 512, 512, 1),
            "z2": _lfm2vl_request(cfg, table, 1536, 1024, 2)}
    z1, z2 = reqs["z1"], reqs["z2"]
    require(z1["shapes"] == [(32, 32)] and z1["units"] == 256,
            f"(z1) 512 px: {z1['shapes']}")
    require(z2["grid"] == (2, 3) and z2["shapes"] == [(32, 32)] * 6
            + [(26, 38)] and z2["units"] == 6 * 256 + 247
            and z2["mm"]["pixels"].shape[:2] == (7, 1024),
            f"(z2) 1536 x 1024: grid {z2['grid']}, {z2['shapes']}")
    warm = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    for name in reqs:
        warm.generate_tokens(reqs[name]["ids"], greedy, max_tokens=4,
                             mm=mm_to(reqs[name]["mm"], torch.device(device)))
    del warm
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    eager = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                       cuda_graphs=False)
    n_attn = model.text.n_attn_layers
    want = {"flash_attention_segmented": 0, "flash_attention": n_attn,
            "flash_decode_at_layer": n_attn * n, "fused_decode_stack": 0}
    outs = {}
    for name, what in (("z1", "512 x 512 image, unsplit, 1024 patches, 256 "
                               "image tokens"),
                       ("z2", "1536 x 1024 image, 3 x 2 tiles of 512 + a "
                              "608 x 416 thumbnail, tower batch 7 x 1024, "
                              "1783 image tokens")):
        mm = mm_to(reqs[name]["mm"], torch.device(device))
        reqs[name]["mm_dev"] = mm
        tower = _wall_ms(lambda: model.encode_vision(params, mm), device)
        outs[name] = _vl3_path(name, what, eng, eager, reqs[name], greedy,
                               ("flash_attention", "flash_decode_at_layer"),
                               want, device, tower, n=n, phase="lfm2vl",
                               readings=SIGLIP_READINGS)
    if device == "cuda":
        att = _tower_attention_ms(cfg, reqs["z2"]["mm_dev"], device)
        SIGLIP_READINGS["z_tower_attention"] = att
        log(f"[lfm2vl] (z2) the tower's plain masked attention, one block: "
            f"device ms {att['ms']:.4f}, masked sdpa {att['library_ms']:.4f}, "
            f"bound {att['bound_ms']:.4f} ({att['bound_by']}) at "
            f"{att['at']} | {card_line()}")
    del eng, eager
    if device == "cuda":
        torch.cuda.empty_cache()
    cut_cfg = lfm2vl_1_6b(**SIGLIP_CUT)
    small = {**params, "layers": params["layers"][:SIGLIP_CUT["layers"]],
             "visual": {**params["visual"], "layers":
                        params["visual"]["layers"][:SIGLIP_CUT["depth"]]}}
    n_cut = sum(t == "full_attention" for t in cut_cfg.text.layer_types)
    # (z2) too: its tiles and padded thumbnail reach the packed tower
    # batch, the resized position tables and the gather across rows
    for name, image in (("z1", "(z1)'s image"),
                        ("z2", "(z2)'s 6 tiles and thumbnail")):
        _vl3_teacher_forced(
            name, Lfm2VLModel, cut_cfg, small, reqs[name], outs[name][:8],
            device, {"flash_attention_segmented": 0,
                     "flash_attention": n_cut,
                     "flash_decode_at_layer": 8 * n_cut}, phase="lfm2vl",
            cut=f"{SIGLIP_CUT['depth']} vision blocks and "
                f"{SIGLIP_CUT['layers']} LFM2 layers ({n_cut} attention), "
                f"{image}")
    return small


#: the chat template's content loop, rendering PaddleOCR-VL's image parts
OCR_TEMPLATE_PARTS = (
    "{% if message.content is string %}{{ message.content }}"
    "{% else %}{% for part in message.content %}"
    "{% if part.type == 'text' %}{{ part.text }}"
    "{% elif part.type == 'image_url' %}"
    "<|IMAGE_START|><|IMAGE_PLACEHOLDER|><|IMAGE_END|>{% endif %}"
    "{% endfor %}{% endif %}")
#: LFM2-VL's: "<image>", which the processor expands
LFM2VL_TEMPLATE_PARTS = (
    "{% if message.content is string %}{{ message.content }}"
    "{% else %}{% for part in message.content %}"
    "{% if part.type == 'text' %}{{ part.text }}"
    "{% elif part.type == 'image_url' %}<image>{% endif %}"
    "{% endfor %}{% endif %}")


def _siglip_checkpoint(tmp: str, kind: str, small: dict) -> str:
    """A servable SIGLIP_CUT directory at the published widths: the test
    tokenizer with the family's image tokens, a chat template with image
    parts, config.json (model type paddleocr_vl or lfm2-vl, the tokenizer's
    image ids), the seeded weights with the embedding rows past the
    tokenizer zeroed.  Returns the registry id its model type names."""
    import dataclasses

    from tokenizers import AddedToken

    from aha_tpu_torch.io import weights
    from aha_tpu_torch.models.lfm2vl import lfm2vl_1_6b
    from aha_tpu_torch.models.paddleocr_vl import paddleocr_vl_0_9b

    fixtures, tok = _smoke_tokenizer(tmp)
    specials = (("<|IMAGE_START|>", "<|IMAGE_PLACEHOLDER|>", "<|IMAGE_END|>")
                if kind == "ocr" else ("<image>",))
    tok.add_special_tokens([AddedToken(t, special=True) for t in specials])
    tok.save(os.path.join(tmp, "tokenizer.json"))
    vocab = tok.get_vocab_size(with_added_tokens=True)
    eos = tok.token_to_id("<|im_end|>")
    parts = OCR_TEMPLATE_PARTS if kind == "ocr" else LFM2VL_TEMPLATE_PARTS
    for name, obj in (("generation_config.json", {"eos_token_id": [eos]}),
                      ("tokenizer_config.json", {"chat_template":
                       fixtures.CHAT_TEMPLATE.replace(
                           "{{ message.content }}", parts)})):
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    t0 = time.perf_counter()
    if kind == "ocr":
        c = paddleocr_vl_0_9b(**SIGLIP_CUT)
        img = tok.token_to_id("<|IMAGE_PLACEHOLDER|>")
        cfg = {**c.text.__dict__, "model_type": "paddleocr_vl",
               "architectures": ["PaddleOCRVLForConditionalGeneration"],
               "torch_dtype": "bfloat16", "use_bias": False,
               "vision_config": dataclasses.asdict(c.vision),
               "rope_scaling": {"mrope_section": list(c.mrope_section),
                                "rope_type": "default"},
               "image_token_id": img, "video_token_id": img,
               "vision_start_token_id": tok.token_to_id("<|IMAGE_START|>")}
        weights.save_hf_paddleocr_vl({**small, "text": _text_rows_zeroed(
            small["text"], vocab)}, tmp)
        model_id = "PaddlePaddle/PaddleOCR-VL"
    else:
        c = lfm2vl_1_6b(**SIGLIP_CUT)
        cfg = {"model_type": "lfm2-vl",
               "architectures": ["Lfm2VlForConditionalGeneration"],
               "torch_dtype": "bfloat16",
               "text_config": {**dataclasses.asdict(c.text), "layer_types":
                               list(c.text.layer_types)},
               "vision_config": dataclasses.asdict(c.vision),
               **{f.name: getattr(c, f.name) for f in dataclasses.fields(c)
                  if f.name not in ("text", "vision")},
               "image_token_id": tok.token_to_id("<image>")}
        weights.save_hf_lfm2vl(_text_rows_zeroed(small, vocab), tmp)
        model_id = "LiquidAI/LFM2-VL-1.6B"
    with open(os.path.join(tmp, "config.json"), "w") as f:
        json.dump(cfg, f)
    log(f"[siglip-http] {model_id} full-width checkpoint "
        f"({SIGLIP_CUT['depth']} vision blocks, {SIGLIP_CUT['layers']} text "
        f"layers) written in {time.perf_counter() - t0:.1f} s (set-up)")
    return model_id


def phase_http_siglip(ocr_small: dict, lfm2vl_small: dict) -> None:
    """Each family's SIGLIP_CUT checkpoint served by `python -m
    aha_tpu_torch serv <dir>` (the model type picks the id) in a child
    under -X importtime (no jax or aha_tpu module): a 224 x 224 PNG image
    chat (64 image tokens: PaddleOCR-VL's 16 x 16 patches, LFM2-VL's 256
    px resize) and a text-only chat."""
    kinds = (("ocr", ocr_small, "OCR:"), ("lfm2vl", lfm2vl_small,
                                           "describe "))
    with contextlib.ExitStack() as stack:
        tmps = [stack.enter_context(tempfile.TemporaryDirectory(
            prefix=f"aha_torch_{kind}_")) for kind, _, _ in kinds]
        ids = [_siglip_checkpoint(tmp, kind, small)
               for tmp, (kind, small, _) in zip(tmps, kinds)]
        with _servers(*((tmp, ()) for tmp in tmps)) as bases:
            for base, model_id, (_, _, task) in zip(bases, ids, kinds):
                image = [{"type": "image_url", "image_url": {
                    "url": _png_data_url(224, 224, 11)}},
                    {"type": "text", "text": task}]
                _vl_chat(base, model_id, image, f"{model_id} image chat", 64)
                _vl_chat(base, model_id, "hello world how are you today",
                         f"{model_id} text chat", 1)


# -- 12. dsocr: DeepSeek-OCR (aa) ---------------------------------------------

#: greedy tokens a (aa) request
DSOCR_TOKENS = 64
#: the teacher-forced check's decoder depth (its dense layer and 3 MoE
#: layers); the towers stay whole
DSOCR_CUT = 4
#: the served checkpoint, at full width: SAM's first 4 blocks (block 2
#: global), CLIP's first 4 layers, the decoder's dense layer and one MoE
#: layer
DSOCR_SERVE = dict(sam=4, clip=4, layers=2)
DSOCR_MODEL = "deepseek-ai/DeepSeek-OCR"
#: per path: TTFT, the tower (wall and device), decode ms/step graphed and
#: eager; the MoE layer's plain timings (one JSON line before the kernels
#: line)
DSOCR_READINGS: dict[str, dict] = {}


def _dsocr_request(cfg, w: int, h: int, seed: int, base: int,
                   image_size: int, crop_mode: bool) -> dict:
    """A seeded w x h image through the served processing (views, Gundam
    tiles, gather index), between seeded text ids as the tokenizer would
    give them (no tokenizer of the published vocabulary is in the
    repository); the host inputs (numpy)."""
    from aha_tpu_torch.models.deepseek_ocr_served import build_mm, image_views

    rng = np.random.default_rng(seed)
    view = image_views(_rgb(w, h, seed), 1, base, image_size, crop_mode)
    ids = ([cfg.language.bos_token_id] + _prompt(rng, 8, 100000)
           + [cfg.image_token_id] * view[3] + _prompt(rng, 8, 100000))
    return {"ids": ids, "mm": build_mm([view], 1), "n_img": view[3],
            "n_crops": len(view[1])}


def _moe_timings(model, params: dict, device: str, step_ms: float) -> None:
    """The plain MoE layer (layer 1's weights) at a decode step (the
    gathered form: 6 experts' weights) and at (aa1)'s and (aa2)'s prefill
    buckets (the capacity buffer over all 64 experts): device ms, its
    bound and, at decode, 11 layers' share of (aa1)'s graphed step."""
    from aha_tpu_torch.ops.moe import default_capacity, moe_gate

    c = model.config.language
    lp = params["layers"][1]
    D, Fm, E, K = (c.hidden_size, c.moe_intermediate_size,
                   c.n_routed_experts, c.num_experts_per_tok)
    Fs = Fm * c.n_shared_experts
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, n in (("decode", 1), ("prefill_512", 512),
                    ("prefill_1024", 1024)):
        h = torch.randn((1, n, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        ms = device_ms(lambda: model.mlp(lp, h), iters=20 if n == 1 else 5)
        hit = K if n == 1 else int(
            moe_gate(lp["moe"]["gate"]["w"], h[0], K)[1].unique().numel())
        b = bound(2 * (3 * hit * D * Fm + 3 * D * Fs) + 4 * D * E
                  + 2 * 2 * n * D, 2 * n * (3 * K * D * Fm + 3 * D * Fs))
        out[name] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                     "experts_read": hit,
                     "capacity": default_capacity(n, K, E)}
        log(f"[dsocr] MoE layer (plain) {name}: device ms {ms:.4f}, bound "
            f"{b[0]:.4f} ({b[1]}; {hit} experts' weights read)")
    n_moe = sum(1 for lp in params["layers"] if "moe" in lp)
    share = n_moe * out["decode"]["ms"] / step_ms
    out["decode"]["share_of_step"] = share
    log(f"[dsocr] MoE at decode: {n_moe} layers x {out['decode']['ms']:.4f} "
        f"ms = {share:.1%} of (aa1)'s graphed step ({step_ms:.3f} ms)")
    DSOCR_READINGS["moe"] = out


def phase_deepseek_ocr(device: str = "cuda") -> dict:
    """(aa) DeepSeek-OCR's published geometry (DeepseekOCRConfig(): SAM
    ViTDet-B at 1024 px, CLIP-L/14, DeepSeek-V2 with 12 layers at 1280, 10
    heads of 128 over 10, 64 routed experts of 896 top-6, 2 shared, the
    first layer dense at 6848, vocab 129280) with seeded bf16 weights on
    the card through TextEngine without a prefix store, as served: (aa1) a
    1024 x 1024 image at base = image = 1024 (273 image tokens, the 512
    bucket) and (aa2) an A4 page at 200 dpi in crop mode at base 1024 (6
    tiles of 640 and the global view, 903 image tokens, the 1024 bucket),
    64 greedy tokens each: the prefill kernel 12 a prefill, row 8 12 a
    step; the MoE layer's plain timings; 8 teacher-forced steps of each at
    the towers' full depth and DSOCR_CUT decoder layers against the f32
    plain path on the CPU.  Returns the parameters for the HTTP phase."""
    import dataclasses

    from aha_tpu_torch.core.engine import TextEngine, bucket_for
    from aha_tpu_torch.core.sampling import SamplingConfig
    from aha_tpu_torch.models.deepseek_ocr import (DeepseekOCRConfig,
                                                   DeepseekOCRModel)
    from aha_tpu_torch.models.qwen2_5vl import mm_to

    greedy, n = SamplingConfig(), DSOCR_TOKENS
    cfg = DeepseekOCRConfig()
    lc = cfg.language
    require((lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim)
            == (10, 10, 128), "DeepSeek-OCR's heads are not 10/10 of 128")
    model = DeepseekOCRModel(cfg, max_rope_len=8192, device=device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(19),
                               dtype=torch.bfloat16)
    _sync(device)
    n_vis = sum(t.numel() for k in ("sam", "clip", "projector")
                for t in _leaves(params[k]))
    n_all = sum(t.numel() for t in _leaves(params))
    log(f"[dsocr] (aa) DeepSeek-OCR geometry: SAM ViTDet-B "
        f"{cfg.sam.depth} blocks at {cfg.sam.embed_dim}, CLIP-L "
        f"{cfg.clip.num_layers} layers at {cfg.clip.hidden_size}, "
        f"DeepSeek-V2 {lc.num_hidden_layers} layers at {lc.hidden_size} "
        f"(10/10 heads of 128; {lc.n_routed_experts} experts of "
        f"{lc.moe_intermediate_size}, top-{lc.num_experts_per_tok}, "
        f"{lc.n_shared_experts} shared; layer 0 dense at "
        f"{lc.intermediate_size}), V={lc.vocab_size}: {n_all / 1e9:.3f} B "
        f"bf16 params ({n_vis / 1e6:.1f} M in the towers) seeded on the "
        f"card in {time.perf_counter() - t0:.1f} s (set-up)")
    reqs = {"aa1": _dsocr_request(cfg, 1024, 1024, 1, 1024, 1024, False),
            "aa2": _dsocr_request(cfg, 1654, 2339, 2, 1024, 640, True)}
    a1, a2 = reqs["aa1"], reqs["aa2"]
    require(a1["n_img"] == 273 and a1["n_crops"] == 0
            and bucket_for(len(a1["ids"])) == 512
            and len(a1["mm"]["gather_idx"]) == 273,
            f"(aa1): {a1['n_img']} image tokens, {len(a1['ids'])} ids")
    require(a2["n_img"] == 903 and a2["n_crops"] == 6
            and bucket_for(len(a2["ids"])) == 1024
            and len(a2["mm"]["gather_idx"]) == 903
            and a2["mm"]["crops"].shape == (6, 3, 640, 640),
            f"(aa2): {a2['n_img']} image tokens, {a2['n_crops']} crops, "
            f"{len(a2['ids'])} ids")
    warm = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    for r in reqs.values():
        warm.generate_tokens(r["ids"], greedy, max_tokens=4,
                             mm=mm_to(r["mm"], torch.device(device)))
    del warm
    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192)
    eager = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                       cuda_graphs=False)
    L = lc.num_hidden_layers
    must = ("flash_attention", "flash_decode_at_layer")
    want = {"flash_attention": L, "flash_decode_at_layer": L * n,
            "flash_attention_segmented": 0, "fused_decode_stack": 0,
            "flash_decode_at_layer_flat": 0, "head_argmax": 0}
    outs = {}
    for tag, what in (("aa1", "1024 x 1024 image at base 1024, 273 image "
                              "tokens (bucket 512)"),
                      ("aa2", "A4 page at 200 dpi (1654 x 2339), crop mode, "
                              "6 tiles of 640 + a 1024 global view, 903 "
                              "image tokens (bucket 1024)")):
        r = reqs[tag]
        mm = mm_to(r["mm"], torch.device(device))
        r["mm_dev"] = mm
        tower = _wall_ms(lambda: model.assemble_vision(params, mm), device)
        tower_dev = (device_ms(lambda: model.assemble_vision(params, mm),
                               iters=2, warmup=1)
                     if device == "cuda" else None)
        outs[tag] = _vl3_path(tag, what, eng, eager, r, greedy, must, want,
                              device, tower, n=n, phase="dsocr",
                              readings=DSOCR_READINGS)
        DSOCR_READINGS[tag]["tower_device_ms"] = tower_dev
        if tower_dev is not None:
            log(f"[dsocr] ({tag}) tower: wall {tower:.2f} ms, device "
                f"{tower_dev:.2f} ms")
    card = card_line() if device == "cuda" else "cpu"
    log(f"[dsocr] (aa) the prefill kernel {L} a prefill (10/10 heads of "
        f"128, G 1), flash_decode_at_layer {L} a step, no segment kernel "
        f"(SAM and CLIP attend plainly, as the reference) | {card}")
    del eng, eager
    if device == "cuda":
        _moe_timings(model, params,
                     device, DSOCR_READINGS["aa1"]
                     ["decode_ms_per_step_graphed"])
        torch.cuda.empty_cache()
    cut_cfg = dataclasses.replace(cfg, language=dataclasses.replace(
        lc, num_hidden_layers=DSOCR_CUT))
    small = {**params, "layers": params["layers"][:DSOCR_CUT]}
    for tag in ("aa1", "aa2"):
        _vl3_teacher_forced(
            tag, DeepseekOCRModel, cut_cfg, small, reqs[tag],
            outs[tag][:8], device,
            {"flash_attention": DSOCR_CUT,
             "flash_decode_at_layer": 8 * DSOCR_CUT}, phase="dsocr",
            cut=f"the towers whole and {DSOCR_CUT} decoder layers (the "
                f"dense one and 3 MoE), ({tag})'s image")
    return params


def _dsocr_checkpoint(tmp: str, params: dict) -> tuple:
    """A servable DSOCR_SERVE cut at the published widths with HF names:
    the test tokenizer and its <image> token, config.json in the published
    layout (language_config, vision_config widths, projector_config), the
    seeded weights with the embedding rows past the tokenizer zeroed.
    Returns (the served model's cut config, the <image> id)."""
    import dataclasses

    from tokenizers import AddedToken

    from aha_tpu_torch.io.weights import save_hf_deepseek_ocr
    from aha_tpu_torch.models.deepseek_ocr import DeepseekOCRConfig

    fixtures, tok = _smoke_tokenizer(tmp)
    tok.add_tokens([AddedToken("<image>", normalized=False)])
    tok.save(os.path.join(tmp, "tokenizer.json"))
    vocab = tok.get_vocab_size(with_added_tokens=True)
    eos, img = tok.token_to_id("<|im_end|>"), tok.token_to_id("<image>")
    c = DeepseekOCRConfig()
    cut = DSOCR_SERVE
    sam = dataclasses.replace(c.sam, depth=cut["sam"],
                              global_attn_indexes=(2,))
    lang = dataclasses.replace(c.language, num_hidden_layers=cut["layers"],
                               bos_token_id=0, eos_token_id=eos)
    cfg = {"language_config": dataclasses.asdict(lang),
           "vision_config": {
               "image_size": sam.img_size, "mlp_ratio": sam.mlp_ratio,
               "width": {"sam_vit_b": {
                   "width": sam.embed_dim, "layers": sam.depth,
                   "heads": sam.num_heads, "out_chans": sam.out_chans,
                   "window_size": sam.window_size,
                   "downsample_channels": [sam.net2_chans, sam.net3_chans],
                   "global_attn_indexes": list(sam.global_attn_indexes)},
                   "clip-l-14-224": {
                       "width": c.clip.hidden_size, "layers": cut["clip"],
                       "heads": c.clip.num_heads,
                       "image_size": c.clip.image_size,
                       "patch_size": c.clip.patch_size}}},
           "projector_config": {"input_dim": c.projector_input_dim,
                                "n_embed": c.projector_n_embed},
           "image_token_id": img, "bos_token_id": 0, "eos_token_id": eos}
    for name, obj in (("config.json", cfg),
                      ("generation_config.json", {"eos_token_id": [eos]})):
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    clip = params["clip"]
    small = {**params,
             "sam": {**params["sam"],
                     "blocks": params["sam"]["blocks"][:cut["sam"]]},
             "clip": {**clip, "layers": _tree_map(
                 lambda t: t[:cut["clip"]], clip["layers"])},
             "layers": params["layers"][:cut["layers"]]}
    t0 = time.perf_counter()
    save_hf_deepseek_ocr(_text_rows_zeroed(small, vocab), tmp)
    log(f"[dsocr-http] {DSOCR_MODEL} full-width checkpoint (SAM "
        f"{cut['sam']} blocks, CLIP {cut['clip']} layers, {cut['layers']} "
        f"decoder layers) written in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")
    return cfg, img


def phase_http_deepseek_ocr(params: dict) -> None:
    """The DSOCR_SERVE checkpoint served by `python -m aha_tpu_torch serv
    <dir> --model deepseek-ai/DeepSeek-OCR` in a child under -X importtime
    (no jax or aha_tpu module): a plain image request (the 640 view) and a
    crop_mode one on a wide image (2 tiles of 640), each reply equal to the
    in-process engine's on the same checkpoint; then `python -m
    aha_tpu_torch run <dir> --model ... --input <png>` in a child, whose
    answer under the family's prompt equals the in-process one."""
    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters

    with tempfile.TemporaryDirectory(prefix="aha_torch_dsocr_") as tmp, \
            contextlib.ExitStack() as runs:
        _, img_id = _dsocr_checkpoint(tmp, params)
        png = os.path.join(tmp, "page.png")
        _rgb(900, 1200, 23).save(png)
        child = runs.enter_context(_run_beside(
            tmp, tmp, "--model", DSOCR_MODEL, "--input", png, "--max-tokens",
            "16", "--max-seq-len", "2048"))
        served = load_model(DSOCR_MODEL, tmp, max_seq_len=2048)

        def body(url, text, **md):
            b = {"model": DSOCR_MODEL, "max_tokens": 16, "temperature": 0.0,
                 "stream": False, "messages": [{"role": "user", "content": [
                     {"type": "image_url", "image_url": {"url": url}},
                     {"type": "text", "text": text}]}]}
            if md:
                b["metadata"] = md
            return b

        asks = {"plain image (640 view)": (body(_png_data_url(800, 600, 21),
                                                "<image>\nFree OCR."), 111),
                "crop_mode, 1400 x 700 (2 tiles of 640)": (
                    body(_png_data_url(1400, 700, 22), "<image>\nFree OCR.",
                         crop_mode="true"), 321)}
        with _server(tmp, "--model", DSOCR_MODEL) as base:
            for what, (b, n_img) in asks.items():
                data = served.get_data(
                    ChatCompletionParameters.model_validate(b))
                require(data.input_ids.count(img_id) == n_img
                        == len(data.mm["gather_idx"]),
                        f"{what}: {data.input_ids.count(img_id)} image "
                        f"tokens")
                want = served.generate(ChatCompletionParameters
                                       .model_validate(b))
                status, text = _post(base + "/v1/chat/completions", b)
                require(status == 200, f"{what}: {text[-500:]}")
                got = json.loads(text)
                reply = got["choices"][0]["message"]["content"]
                require(reply == want.choices[0].message.content
                        and got["usage"]["prompt_tokens"]
                        == want.usage.prompt_tokens,
                        f"{what}: served {reply!r} vs in-process "
                        f"{want.choices[0].message.content!r}")
                log(f"[dsocr-http] {what}: {n_img} image tokens, "
                    f"{got['usage']['prompt_tokens']}-token prompt, reply "
                    f"equal to the in-process engine's "
                    f"({got['usage']['completion_tokens']} tokens)")
        want = served.generate(ChatCompletionParameters.model_validate(
            body(f"file://{png}",
                 "<image>\nConvert the document to markdown. ")))
        lines, secs = _run_lines(child, DSOCR_MODEL)
        require("\n".join(lines) == want.choices[0].message.text(),
                f"run printed {lines!r}")
        log(f"[dsocr-http] `run` of {DSOCR_MODEL} answered a 900 x 1200 page "
            f"under the family's prompt as the in-process engine does "
            f"({secs:.1f} s, load included, beside the served child)")
        del served


# -- 14. ASR: Qwen3-ASR-0.6B (ab) and Fun-ASR-Nano (ac) ------------------------

#: greedy tokens a request (bench_asr_rtfx's 80)
ASR_TOKENS = 80
#: the teacher-forced check's decoder depth (the encoders stay whole)
ASR_CUT = 4
#: the served checkpoints at full width: Qwen3-ASR's first 4 encoder layers
#: and 2 decoder layers; Fun-ASR's first 4 SANM blocks (encoders0 and 3),
#: 2 tp blocks, the adaptor whole and 2 LLM layers
ASR_SERVE = {"qwen3_asr": dict(encoder=4, layers=2),
             "fun_asr": dict(blocks=4, tp=2, layers=2)}
QWEN3_ASR_MODEL = "Qwen/Qwen3-ASR-0.6B"
FUN_ASR_MODEL = "FunAudioLLM/Fun-ASR-Nano-2512"
SAMPLE_WAV = os.path.join(ROOT, "assets", "audio", "sample.wav")
#: FireRedVAD: frame-by-frame streaming probabilities against the offline
#: pass (tests/test_torch_fire_red_vad.py's TOL_PROBS), and the card's
#: offline probabilities against the CPU's
TOL_VAD = 1e-5
TOL_VAD_CPU = 1e-4
#: per path: RTFx, front end, encoder (wall and device), TTFT, decode
#: ms/step graphed and eager; the design candidates' timings; FireRedVAD's
#: segments (one JSON line before the kernels line)
ASR_READINGS: dict[str, dict] = {}


def asr_configs():
    """(Qwen3-ASR-0.6B at bench_asr_rtfx's geometry, bench.py:247-250:
    Qwen3ASRAudioConfig() — 18 layers at 896, 14 heads of 64 — over
    Qwen3Config() = Qwen3-0.6B; Fun-ASR-Nano at the JAX package's default
    geometry, FunAsrNanoConfig(): a 512-wide SANM encoder of 50 + 20
    blocks at 4 heads of 128, the adaptor to 1024 at 8 heads of 128,
    Qwen3-0.6B as its LLM — no published config.json is in the
    repository)."""
    from aha_tpu_torch.models.fun_asr_nano import FunAsrNanoConfig
    from aha_tpu_torch.models.qwen3 import Qwen3Config
    from aha_tpu_torch.models.qwen3_asr import (Qwen3ASRAudioConfig,
                                                Qwen3ASRConfig)

    return (Qwen3ASRConfig(audio=Qwen3ASRAudioConfig(), text=Qwen3Config()),
            FunAsrNanoConfig())


def _asr_wave(secs: float = 30.0) -> np.ndarray:
    """bench_asr_rtfx's waveform (bench.py:255-258)."""
    return np.random.default_rng(0).standard_normal(
        int(16000 * secs)).astype(np.float32) * 0.05


def _wav_url(wav: np.ndarray) -> str:
    import base64

    from aha_tpu_torch.utils.audio import wav_bytes

    return "data:audio/wav;base64," + base64.b64encode(
        wav_bytes(wav, 16000)).decode()


def _asr_tokenizer(tmp: str):
    """tests/fixtures.py's test tokenizer with Qwen3-ASR's three audio
    tokens, a chat template that renders an audio_url part as the audio
    marker, and its eos in generation_config.json, written under `tmp`."""
    from tokenizers import AddedToken

    fixtures, tok = _smoke_tokenizer(tmp)
    tok.add_special_tokens([AddedToken(t, special=True) for t in (
        "<|audio_start|>", "<|audio_pad|>", "<|audio_end|>")])
    tok.save(os.path.join(tmp, "tokenizer.json"))
    template = fixtures.CHAT_TEMPLATE.replace(
        "{{ message.content }}",
        "{% if message.content is string %}{{ message.content }}"
        "{% else %}{% for part in message.content %}"
        "{% if part.type == 'text' %}{{ part.text }}"
        "{% elif part.type == 'audio_url' %}"
        "<|audio_start|><|audio_pad|><|audio_end|>{% endif %}"
        "{% endfor %}{% endif %}")
    for name, obj in (("tokenizer_config.json", {"chat_template": template}),
                      ("generation_config.json", {"eos_token_id": [
                          tok.token_to_id("<|im_end|>")]})):
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    return tok


def _asr_chat(cls, model_id: str, model, params: dict, tmp: str,
              cuda_graphs: bool = True):
    """The served chat class over an in-process model: a TextEngine without
    a prefix store or eos (every request runs its max_tokens), the test
    tokenizer and template under `tmp`."""
    from aha_tpu_torch.core.chat_template import ChatTemplate
    from aha_tpu_torch.core.engine import TextEngine
    from aha_tpu_torch.core.tokenizer import TokenizerModel
    from aha_tpu_torch.models.fun_asr_nano_served import FunAsrNanoChat
    from aha_tpu_torch.registry import lookup

    eng = TextEngine(model, params, eos_token_ids=[], max_seq_len=8192,
                     cuda_graphs=cuda_graphs)
    template = (ChatTemplate.str_init("{{ messages }}")
                if cls is FunAsrNanoChat else ChatTemplate.init(tmp))
    chat = cls(lookup(model_id), eng, TokenizerModel.init(tmp), template,
               {}, model_name="smoke")
    chat.asr_model = model
    return chat


def _asr_request(url: str, n: int | None = None, **md):
    from aha_tpu_torch.params import ChatCompletionParameters

    body = {"model": "smoke", "messages": [{"role": "user", "content": [
        {"type": "audio_url", "audio_url": {"url": url}}]}]}
    if n is not None:
        body["max_tokens"] = n
    if md:
        body["metadata"] = md
    return ChatCompletionParameters.model_validate(body)


def _asr_path(tag: str, what: str, chat, eager, mes, wav: np.ndarray,
              frontend, encode, device: str, n: int = ASR_TOKENS) -> dict:
    """One request through the served chat's preprocessing (`get_data`),
    then `n` greedy tokens through the graphed engine with the counters
    zeroed before and read after (row 1 at 28 for a prompt bucket of ≥ 128
    rows, rows 3 and 4 once a decode step, row 2 never, row 10 at 72 for
    Fun-ASR), eager_twin; the served `generate` of the same request must
    reply with the same tokens' text.  Then RTFx as bench_asr_rtfx
    measures it — front end (`frontend(wav, ids)` → mm) + encoder +
    prefill + n tokens, best of 2 after the warm-up — the encoder alone
    (wall and device) and TTFT (front end + the engine's prompt time).
    `frontend(wav, mm)` rebuilds the request's `mm` from the 16 kHz
    waveform (the prepared one tells it the prompt's layout)."""
    from aha_tpu_torch.core.engine import DECODE_BLOCK, bucket_for
    from aha_tpu_torch.models.fun_asr_nano_served import FunAsrNanoChat

    greedy = _greedy()
    data = chat.get_data(mes)
    ids, mm = data.input_ids, data.mm
    fun = isinstance(chat, FunAsrNanoChat)
    L = chat.asr_model.n_layers
    steps = DECODE_BLOCK * -(-(n - 1) // DECODE_BLOCK)
    want = {"flash_attention": L if bucket_for(len(ids)) >= 128 else 0,
            "fused_decode_stack": steps, "head_argmax": steps,
            "flash_decode_at_layer_flat": 0, "flash_decode_at_layer": 0,
            "flash_attention_segmented": 72 if fun else 0}
    must = tuple(k for k, v in want.items() if v)
    eng = chat.engine
    wr = zero_counts()
    _sync(device)
    out = eng.generate_tokens(ids, greedy, max_tokens=n, mm=mm)
    _sync(device)
    t = eng.last_timing
    counts = read_counts(wr, f"asr-{tag}", must)
    require(device != "cuda" or all(counts[k] == c for k, c in want.items()),
            f"({tag}) launches {counts}, want {want}")
    require(len(out) == n, f"({tag}): {len(out)} tokens")
    reply = chat.generate(mes).choices[0].message.content
    require(reply == chat.tokenizer.decode(out), f"({tag}) the served "
            f"generate replied {reply!r}, the engine's tokens decode to "
            f"{chat.tokenizer.decode(out)!r}")

    def run(e):
        return [e.generate_tokens(ids, greedy, max_tokens=n, mm=mm)], \
            [e.last_timing]

    eager_twin(f"({tag}) {what}", eng, lambda: eager.engine, run, [out],
               counts, device)
    g = GRAPH_READINGS[-1]
    secs = len(wav) / 16000
    fe_ms = _wall_ms(lambda: frontend(wav, mm), device)

    def once():
        _sync(device)
        t0 = time.perf_counter()
        eng.generate_tokens(ids, greedy, max_tokens=n, mm=frontend(wav, mm))
        _sync(device)
        return secs / (time.perf_counter() - t0)

    rtfx = [once(), once()]
    enc_ms = _wall_ms(lambda: encode(mm), device)
    enc_dev = (device_ms(lambda: encode(mm), iters=3, warmup=1)
               if device == "cuda" else None)
    ttft = fe_ms + t.prompt_secs * 1e3
    card = card_line() if device == "cuda" else "cpu"
    log(f"[asr] ({tag}) {what}: {t.prompt_tokens}-token prompt (bucket "
        f"{bucket_for(len(ids))}); RTFx {max(rtfx):.1f} (best of "
        f"{', '.join(f'{r:.1f}' for r in rtfx)}: {secs:.0f} s of audio, front "
        f"end + encoder + prefill + {n} tokens); front end {fe_ms:.2f} ms, "
        f"encoder {enc_ms:.2f} ms wall"
        + (f" / {enc_dev:.2f} device" if enc_dev is not None else "")
        + f"; TTFT {ttft:.2f} ms; decode {g['ms_per_step_graphed']:.3f} "
        f"ms/step graphed, {g['ms_per_step_eager']:.3f} eager | {card}")
    ASR_READINGS[tag] = {
        "what": what, "prompt_tokens": t.prompt_tokens,
        "audio_s": secs, "rtfx": max(rtfx), "rtfx_runs": rtfx,
        "frontend_ms": fe_ms, "encoder_wall_ms": enc_ms,
        "encoder_device_ms": enc_dev, "ttft_ms": ttft,
        "decode_ms_per_step_graphed": g["ms_per_step_graphed"],
        "decode_ms_per_step_eager": g["ms_per_step_eager"],
        "launches": {k: counts[k] for k in want}, "card": card}
    return {"ids": ids, "out": out, "mm": mm}


def _greedy():
    from aha_tpu_torch.core.sampling import SamplingConfig

    return SamplingConfig()


def _asr_candidates(q_model, q_params: dict, f_model, device: str) -> None:
    """The two H100 design candidates the slice leaves plain, at (ab1)'s
    and (ac1)'s shapes (device ms; timed only): Qwen3-ASR's encoder
    attention — the plain masked sdpa of the reference, 14 heads of 64 over
    S 416 in the encoder's float32 — beside F.scaled_dot_product_attention
    with the same boolean key mask (float32, and bfloat16), and
    Fun-ASR's FSMN memory (the depthwise conv of v plus v, (1, 512, 512)
    float32, 11 taps)."""
    from aha_tpu_torch.ops.attention import sdpa

    a = q_model.config.audio
    S, H, hd = 416, a.encoder_attention_heads, q_model.audio_head_dim
    g = torch.Generator(device=device).manual_seed(416)
    q, k, v = (torch.randn((1, S, H, hd), generator=g, device=device)
               for _ in range(3))
    keep = torch.arange(S, device=device) < 390
    add = torch.where(keep, 0.0, torch.finfo(torch.float32).min)[
        None, None, None]
    ref = sdpa(q, k, v, add)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = _sdpa(qt, kt, vt, attn_mask=keep[None, None, None]).transpose(1, 2)
    err = (got - ref).abs().max().item()
    require(err <= TOL_ATTN, f"the encoder's masked sdpa differs from "
            f"F.sdpa by {err}")
    e = f_model.config.encoder
    taps = torch.randn((e.output_size, 1, e.kernel_size), generator=g,
                       device=device).to(embed_dtype(q_params))
    vv = torch.randn((1, 512, e.output_size), generator=g, device=device)
    out = {"encoder_attention": {"shape": f"1 x {S} x {H} x {hd} f32, key "
                                          f"mask of 390 real rows"},
           "fsmn_memory": {"shape": f"1 x 512 x {e.output_size} f32, "
                                    f"{e.kernel_size} taps"}}
    if device == "cuda":
        plain = device_ms(lambda: sdpa(q, k, v, add))
        lib = device_ms(lambda: _sdpa(qt, kt, vt,
                                      attn_mask=keep[None, None, None]))
        lib_bf = device_ms(lambda: _sdpa(
            qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
            attn_mask=keep[None, None, None]))
        fsmn = device_ms(lambda: f_model.fsmn_memory(vv, taps))
        out["encoder_attention"].update(
            plain_ms=plain, sdpa_ms=lib, sdpa_bf16_ms=lib_bf,
            layers=a.encoder_layers,
            share_of_encoder=a.encoder_layers * plain
            / ASR_READINGS["ab1"]["encoder_device_ms"])
        out["fsmn_memory"].update(
            ms=fsmn, blocks=e.num_blocks + e.tp_blocks,
            share_of_encoder=(e.num_blocks + e.tp_blocks) * fsmn
            / ASR_READINGS["ac1"]["encoder_device_ms"])
        log(f"[asr] design candidates (device ms, timed only): Qwen3-ASR "
            f"encoder attention plain {plain:.4f} vs F.sdpa f32 {lib:.4f} / "
            f"bf16 {lib_bf:.4f} ({a.encoder_layers} layers: "
            f"{out['encoder_attention']['share_of_encoder']:.1%} of (ab1)'s "
            f"encoder); Fun-ASR FSMN memory {fsmn:.4f} "
            f"({e.num_blocks + e.tp_blocks} blocks: "
            f"{out['fsmn_memory']['share_of_encoder']:.1%} of (ac1)'s "
            f"encoder) | {card_line()}")
    ASR_READINGS["candidates"] = out


def _vad_check(device: str) -> None:
    """FireRedVAD on the card: seeded DFSMNs at the reference's default
    geometries (weights at scale 0.05, where the probabilities do not
    saturate, and the default VAD's output bias set so that about 45 % of
    sample.wav's frames lie over its threshold), CMVN from sample.wav's
    own fbank.  The default VAD's offline `detect_waveform` of sample.wav,
    its probabilities against the same detector's on the CPU within
    TOL_VAD_CPU and its segments equal to the CPU's; the stream VAD's
    frame-by-frame probabilities (one feature row a call through its
    caches) against its offline pass within TOL_VAD."""
    from aha_tpu_torch.models import fire_red_vad as fr
    from aha_tpu_torch.ops.audio_feats import kaldi_fbank
    from aha_tpu_torch.utils.audio import prepare_audio

    wav = prepare_audio(SAMPLE_WAV)
    fb = kaldi_fbank(wav).astype(np.float64)
    stats = np.stack([np.append(fb.sum(0), len(fb)),
                      np.append((fb ** 2).sum(0), len(fb))])
    cmvn = fr.CMVN(stats.astype(np.float32))
    feats = torch.from_numpy(fr.extract_feats(cmvn, wav))[None]
    g = torch.Generator(device="cpu")
    cfg = fr.FireRedVadConfig.default_vad()
    cpu = fr.DetectModel(fr.DetectModelConfig.default_vad())
    params = cpu.init_random(g.manual_seed(21), scale=0.05)
    logits = torch.logit(cpu.forward(params, feats)[0][0, :, 0].double())
    # the threshold between two frames' logits, about 45 % of them above
    params["out"]["b"] += float(np.log(cfg.speech_threshold
                                       / (1 - cfg.speech_threshold))
                                - logits.quantile(0.55))
    vad_cpu = fr.FireRedVad(cpu, params, cmvn, cfg)
    card = fr.DetectModel(fr.DetectModelConfig.default_vad(), device)
    vad = fr.FireRedVad(card, _tree_to(params, device, torch.float32), cmvn,
                        cfg)
    t0 = time.perf_counter()
    res = vad.detect_waveform(wav)
    _sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    p_dev, p_cpu = vad.frame_probs(wav)[:, 0], vad_cpu.frame_probs(wav)[:, 0]
    err_cpu = float(np.abs(p_dev - p_cpu).max())
    speech = float((p_dev >= cfg.speech_threshold).mean())
    require(0.2 < speech < 0.8, f"VAD: {speech:.0%} of frames over the "
            "threshold")
    require(err_cpu <= TOL_VAD_CPU, f"VAD probabilities on {device} vs the "
            f"CPU: {err_cpu}")
    # a smoothed probability within the tolerance of the threshold may
    # decide either way on the two devices
    near = np.abs(fr.smooth_probs(p_cpu, cfg.smooth_window_size)
                  - cfg.speech_threshold) <= max(10 * err_cpu, 1e-6)
    require(near.any() or res.timestamps
            == vad_cpu.detect_waveform(wav).timestamps,
            "VAD segments differ from the CPU's")
    model = fr.DetectModel(fr.DetectModelConfig.default_stream_vad(), device)
    sp = _tree_to(model.init_random(g.manual_seed(22), scale=0.05), device,
                  torch.float32)
    fd = feats.to(device)
    offline, _ = model.forward(sp, fd)
    caches, rows = None, []
    for i in range(fd.shape[1]):
        p, caches = model.forward(sp, fd[:, i:i + 1], caches, streaming=True)
        rows.append(p)
    err = (torch.cat(rows, 1) - offline).abs().max().item()
    require(err <= TOL_VAD, f"VAD streaming vs offline: {err}")
    line = card_line() if device == "cuda" else "cpu"
    log(f"[asr] FireRedVAD (seeded, default VAD: r 8, h 256, p 128, n1 = n2 "
        f"= 20) on sample.wav: {len(p_dev)} frames, probabilities "
        f"{p_dev.min():.3f}-{p_dev.max():.3f} ({speech:.0%} over "
        f"{cfg.speech_threshold}), {len(res.timestamps)} segments ("
        f"{'a frame at the threshold' if near.any() else 'the CPU' + chr(39) + 's'}), within {err_cpu:.1e} of the CPU's probabilities (tol "
        f"{TOL_VAD_CPU}); detect_waveform {wall:.1f} ms wall; the stream "
        f"VAD frame by frame within {err:.1e} of its offline pass (tol "
        f"{TOL_VAD}) | {line}")
    ASR_READINGS["vad"] = {"frames": len(p_dev), "speech_share": speech,
                           "segments": res.timestamps,
                           "err_vs_cpu": err_cpu, "stream_err": err,
                           "detect_waveform_ms": wall}


def phase_asr(device: str = "cuda") -> dict:
    """(ab) Qwen3-ASR-0.6B and (ac) Fun-ASR-Nano (asr_configs) with seeded
    bf16 weights (embedding rows past the test tokenizer's vocabulary
    zeroed, so replies decode to text) through their served chat classes
    on TextEngine without a prefix store: (ab1) / (ac1) bench_asr_rtfx's
    30 s waveform (Qwen3-ASR: the 3,200-frame bucket, S 416 encoder rows,
    390 audio tokens, the 512 prompt bucket; Fun-ASR: 500 LFR rows in the
    512 bucket, 63 audio tokens, the 128 prompt bucket), (ab2) / (ac2)
    assets/audio/sample.wav (3 s; (ab2) with language English), 80 greedy
    tokens each (_asr_path); 8 teacher-forced steps of (ab1) and (ac1) with
    the encoders whole and ASR_CUT decoder layers against the f32 plain
    path on the CPU; the design candidates' timings; FireRedVAD
    (_vad_check).  Returns what the HTTP phase serves."""
    import dataclasses

    from aha_tpu_torch.models.fun_asr_nano import FunAsrNanoModel
    from aha_tpu_torch.models.fun_asr_nano_served import (FunAsrNanoChat,
                                                          build_mm)
    from aha_tpu_torch.models.qwen2_5vl import mm_to
    from aha_tpu_torch.models.qwen3_asr import Qwen3ASRModel
    from aha_tpu_torch.models.qwen3_asr_served import Qwen3ASRChat, mel_for
    from aha_tpu_torch.ops.audio_feats import apply_lfr, kaldi_fbank
    from aha_tpu_torch.utils.audio import prepare_audio

    tmp = tempfile.mkdtemp(prefix="aha_torch_asr_")
    tok = _asr_tokenizer(tmp)
    vocab = tok.get_vocab_size(with_added_tokens=True)
    pad_id = tok.token_to_id("<|audio_pad|>")
    q_cfg, f_cfg = asr_configs()
    q_cfg = dataclasses.replace(q_cfg, audio_token_id=pad_id)
    dev = torch.device(device)
    wav30, wav3 = _asr_wave(), prepare_audio(SAMPLE_WAV)
    require(len(wav3) == 48000, f"sample.wav: {len(wav3)} samples")
    gen = torch.Generator(device=device)
    out = {"tmp": tmp}

    # (ab) Qwen3-ASR-0.6B
    t0 = time.perf_counter()
    q_model = Qwen3ASRModel(q_cfg, max_rope_len=8192, device=device)
    q_params = q_model.init_random(gen.manual_seed(20), dtype=torch.bfloat16)
    q_params = {**q_params, "text": _text_rows_zeroed(q_params["text"],
                                                      vocab)}
    _sync(device)
    a = q_cfg.audio
    log(f"[asr] (ab) Qwen3-ASR-0.6B geometry (bench.py's): encoder "
        f"{a.encoder_layers} layers at {a.d_model} ({a.encoder_attention_heads}"
        f" heads of {q_model.audio_head_dim}, convs of "
        f"{a.downsample_hidden_size}), Qwen3-0.6B decoder "
        f"({q_cfg.text.num_hidden_layers} layers at "
        f"{q_cfg.text.hidden_size}): {sum(t.numel() for t in _leaves(q_params)) / 1e9:.3f}"
        f" B bf16 params seeded in {time.perf_counter() - t0:.1f} s (set-up)")
    chat = _asr_chat(Qwen3ASRChat, QWEN3_ASR_MODEL, q_model, q_params, tmp)
    eager = _asr_chat(Qwen3ASRChat, QWEN3_ASR_MODEL, q_model, q_params, tmp,
                      cuda_graphs=False)

    def q_frontend(wav, mm):
        mel, _, n_out = mel_for(wav, a.num_mel_bins, dev)
        return {"mel": mel, "n_out": n_out}

    def q_encode(mm):
        return q_model.encode_audio(q_params["audio"], mm["mel"], mm["n_out"])

    reqs = {"ab1": (_asr_request(_wav_url(wav30), ASR_TOKENS), wav30,
                    "30 s seeded waveform (3,200-frame bucket, S 416, 390 "
                    "audio tokens)"),
            "ab2": (_asr_request(f"file://{SAMPLE_WAV}", ASR_TOKENS,
                                 language="English"), wav3,
                    "sample.wav, 3 s, language English (400-frame bucket, "
                    "39 audio tokens)")}
    for tag, (mes, wav, _) in reqs.items():    # warm-up: graphs, cuDNN
        d = chat.get_data(mes)
        chat.engine.generate_tokens(d.input_ids, _greedy(), 4, mm=d.mm)
    paths = {tag: _asr_path(tag, what, chat, eager, mes, wav, q_frontend,
                            q_encode, device)
             for tag, (mes, wav, what) in reqs.items()}
    ab1 = paths["ab1"]
    require(ab1["mm"]["n_out"] == 390 and ab1["mm"]["mel"].shape[-1] == 3200
            and ab1["ids"].count(pad_id) == 390,
            f"(ab1): n_out {ab1['mm']['n_out']}, mel "
            f"{tuple(ab1['mm']['mel'].shape)}")
    del chat, eager
    cut = dataclasses.replace(q_cfg, text=dataclasses.replace(
        q_cfg.text, num_hidden_layers=ASR_CUT))
    small = {**q_params, "text": _text_cut(q_params["text"], ASR_CUT)}
    _vl3_teacher_forced(
        "ab1", Qwen3ASRModel, cut, small,
        {"ids": ab1["ids"], "mm": {"mel": ab1["mm"]["mel"].cpu().numpy(),
                                   "n_out": np.int32(ab1["mm"]["n_out"])}},
        ab1["out"][:8], device,
        _cut_launches(ab1["ids"], 0), phase="asr",
        cut=f"the encoder whole and {ASR_CUT} decoder layers, (ab1)'s 30 s")
    out["qwen3_asr"] = (q_cfg, q_params)

    # (ac) Fun-ASR-Nano
    t0 = time.perf_counter()
    f_model = FunAsrNanoModel(f_cfg, max_rope_len=8192, device=device)
    f_params = f_model.init_random(gen.manual_seed(30), dtype=torch.bfloat16)
    f_params = {**f_params, "text": _text_rows_zeroed(f_params["text"],
                                                      vocab)}
    _sync(device)
    e = f_cfg.encoder
    log(f"[asr] (ac) Fun-ASR-Nano at the JAX package's default geometry: "
        f"SANM encoder {e.num_blocks} + {e.tp_blocks} blocks at "
        f"{e.output_size} ({e.attention_heads} heads of "
        f"{e.output_size // e.attention_heads}, FSMN {e.kernel_size} taps), "
        f"adaptor to {f_cfg.adaptor.llm_dim} ({f_cfg.adaptor.n_layer} blocks,"
        f" {f_cfg.adaptor.attention_heads} heads), Qwen3-0.6B LLM: "
        f"{sum(t.numel() for t in _leaves(f_params)) / 1e9:.3f} B bf16 "
        f"params seeded in {time.perf_counter() - t0:.1f} s (set-up)")
    chat = _asr_chat(FunAsrNanoChat, FUN_ASR_MODEL, f_model, f_params, tmp)
    eager = _asr_chat(FunAsrNanoChat, FUN_ASR_MODEL, f_model, f_params, tmp,
                      cuda_graphs=False)

    def f_frontend(wav, mm):
        feats = apply_lfr(kaldi_fbank(wav, num_mel_bins=e.n_mels), e.lfr_m,
                          e.lfr_n)
        # the prepared mask's length is the prompt's bucket
        fmask = mm["fbank_mask"].cpu().numpy()
        return mm_to(build_mm(feats, len(fmask), int(fmask.argmax()),
                              int(fmask.sum())), dev)

    def f_encode(mm):
        return f_model.encode_audio(f_params["audio"], mm["speech"],
                                    mm["seg"])

    reqs = {"ac1": (_asr_request(_wav_url(wav30), ASR_TOKENS), wav30,
                    "30 s seeded waveform (500 LFR rows in the 512 bucket, "
                    "63 audio tokens)"),
            "ac2": (_asr_request(f"file://{SAMPLE_WAV}", ASR_TOKENS), wav3,
                    "sample.wav, 3 s (50 LFR rows in the 64 bucket, 7 audio "
                    "tokens)")}
    for tag, (mes, wav, _) in reqs.items():
        d = chat.get_data(mes)
        chat.engine.generate_tokens(d.input_ids, _greedy(), 4, mm=d.mm)
    paths = {tag: _asr_path(tag, what, chat, eager, mes, wav, f_frontend,
                            f_encode, device)
             for tag, (mes, wav, what) in reqs.items()}
    ac1 = paths["ac1"]
    n_tok = int(ac1["mm"]["fbank_mask"].sum())
    require(ac1["mm"]["speech"].shape[1] == 512
            and int(ac1["mm"]["seg"].ge(0).sum()) == 500 and n_tok == 63,
            f"(ac1): speech {tuple(ac1['mm']['speech'].shape)}, {n_tok} "
            f"audio tokens")
    del chat, eager
    cut = dataclasses.replace(f_cfg, llm=dataclasses.replace(
        f_cfg.llm, num_hidden_layers=ASR_CUT))
    small = {**f_params, "text": _text_cut(f_params["text"], ASR_CUT)}
    _vl3_teacher_forced(
        "ac1", FunAsrNanoModel, cut, small,
        {"ids": ac1["ids"],
         "mm": {k: v.cpu().numpy() for k, v in ac1["mm"].items()}},
        ac1["out"][:8], device,
        _cut_launches(ac1["ids"], 72), phase="asr",
        cut=f"the encoder and adaptor whole and {ASR_CUT} LLM layers, "
            f"(ac1)'s 30 s")
    out["fun_asr"] = (f_cfg, f_params)
    _asr_candidates(q_model, q_params, f_model, device)
    _vad_check(device)
    return out


def _cut_launches(ids: list[int], segmented: int) -> dict:
    """The teacher-forced check's launches on the card: the prefill kernel
    ASR_CUT times for a prompt bucket of ≥ 128 rows, the flat-cache decode
    ASR_CUT a forced step (8 steps, no window: the per-op layers), the
    segment kernel `segmented` times."""
    from aha_tpu_torch.core.engine import bucket_for

    return {"flash_attention": ASR_CUT if bucket_for(len(ids)) >= 128
            else 0, "flash_decode_at_layer_flat": 8 * ASR_CUT,
            "flash_attention_segmented": segmented}


def _text_cut(text: dict, layers: int) -> dict:
    """A decoder tree's first `layers` stacked layers, as views."""
    return {**text, "layers": _tree_map(lambda t: t[:layers], text["layers"])}


# -- 15. asr-http: the ASR checkpoints served --------------------------------


def _multipart(url: str, fields: dict, filename: str,
               data: bytes) -> tuple[int, str]:
    """(status, body) of a multipart/form-data POST: `fields` as text
    parts, then the file part."""
    boundary = "aha-smoke-7d1c"
    body = b"".join(
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
        f"{v}\r\n".encode() for k, v in fields.items())
    body += (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
             f'filename="{filename}"\r\nContent-Type: audio/wav\r\n\r\n'
             ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "multipart/form-data; "
                                                 f"boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _asr_checkpoints(asr: dict, tmp: str) -> dict:
    """ASR_SERVE's cuts at full width, each in its own directory under
    `tmp` with the test tokenizer (_asr_tokenizer) and config.json in the
    published layout: Qwen3-ASR's thinker_config (audio_config,
    text_config, audio_token_id) written by save_hf_qwen3_asr, Fun-ASR's
    audio_encoder_conf / frontend_conf / audio_adaptor_conf / llm_conf by
    save_hf_fun_asr_nano.  Returns {name: directory}."""
    import dataclasses

    from aha_tpu_torch.io.weights import (save_hf_fun_asr_nano,
                                          save_hf_qwen3_asr)

    dirs = {}
    q_cfg, q_params = asr["qwen3_asr"]
    c = ASR_SERVE["qwen3_asr"]
    d = dirs["qwen3_asr"] = os.path.join(tmp, "qwen3_asr")
    os.makedirs(d)
    _asr_tokenizer(d)
    audio = dataclasses.replace(q_cfg.audio, encoder_layers=c["encoder"])
    text = dataclasses.replace(q_cfg.text, num_hidden_layers=c["layers"])
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"thinker_config": {
            "audio_config": dataclasses.asdict(audio),
            "text_config": dataclasses.asdict(text),
            "audio_token_id": q_cfg.audio_token_id}}, f)
    t0 = time.perf_counter()
    save_hf_qwen3_asr({"audio": {**q_params["audio"], "layers": q_params[
        "audio"]["layers"][:c["encoder"]]},
        "text": _text_cut(q_params["text"], c["layers"])}, d)
    f_cfg, f_params = asr["fun_asr"]
    c = ASR_SERVE["fun_asr"]
    d = dirs["fun_asr"] = os.path.join(tmp, "fun_asr")
    os.makedirs(d)
    _asr_tokenizer(d)
    enc = dataclasses.asdict(dataclasses.replace(
        f_cfg.encoder, num_blocks=c["blocks"], tp_blocks=c["tp"]))
    frontend = {k: enc.pop(k) for k in ("n_mels", "lfr_m", "lfr_n")}
    llm = dataclasses.replace(f_cfg.llm, num_hidden_layers=c["layers"])
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"audio_encoder_conf": enc, "frontend_conf": frontend,
                   "audio_adaptor_conf": dataclasses.asdict(f_cfg.adaptor),
                   "llm_conf": dataclasses.asdict(llm)}, f)
    ap = f_params["audio"]
    save_hf_fun_asr_nano({"audio": {
        **ap, "encoders": ap["encoders"][:c["blocks"] - 1],
        "tp_encoders": ap["tp_encoders"][:c["tp"]]},
        "text": _text_cut(f_params["text"], c["layers"])}, d)
    log(f"[asr-http] full-width checkpoints written in "
        f"{time.perf_counter() - t0:.1f} s (set-up): {QWEN3_ASR_MODEL} "
        f"(encoder {ASR_SERVE['qwen3_asr']['encoder']} layers, decoder "
        f"{ASR_SERVE['qwen3_asr']['layers']}), {FUN_ASR_MODEL} ("
        f"{c['blocks']} + {c['tp']} SANM blocks, the adaptor, {c['layers']} "
        f"LLM layers)")
    return dirs


@contextlib.contextmanager
def _run_beside(tmp: str, *args: str):
    """`python -m aha_tpu_torch run *args` started in a child, its output
    to files under `tmp`, so it runs beside the served child; the body
    reads it with `_run_lines`, and the child is stopped if it still runs
    when the body ends."""
    n = sum(1 for f in os.listdir(tmp) if f.startswith("run_"))
    out = open(os.path.join(tmp, f"run_{n}.out"), "w+")
    err = open(os.path.join(tmp, f"run_{n}.err"), "w+")
    proc = subprocess.Popen([sys.executable, "-m", "aha_tpu_torch", "run",
                             *args], cwd=ROOT, stdout=out, stderr=err,
                            text=True)
    try:
        yield proc, out, err, time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def _run_lines(child, what: str) -> tuple[list[str], float]:
    """A `_run_beside` child's printed lines between its load and generate
    times (it must exit 0; a seeded reply may hold any character, so the
    output splits at newlines only), and its wall seconds."""
    proc, out, err, t0 = child
    proc.wait(timeout=600)
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    require(proc.returncode == 0, f"run {what}: {stderr[-2000:]}")
    lines = stdout.rstrip("\n").split("\n")
    require(lines[0].startswith("load model use time: ")
            and lines[-1].startswith("generate use time: "),
            f"run {what} printed {stdout[-1000:]!r}")
    return lines[1:-1], time.perf_counter() - t0


def phase_http_asr(asr: dict) -> None:
    """ASR_SERVE's checkpoints: Qwen3-ASR served by `python -m
    aha_tpu_torch serv <dir> --model Qwen/Qwen3-ASR-0.6B` in a child under
    -X importtime (no jax or aha_tpu module): a multipart POST of
    sample.wav to /v1/audio/transcriptions with language=en, whose text
    equals the in-process served model's cleaned reply to the same
    request, and a chat request with an audio_url part, equal likewise;
    then `run` of each id in a child with --input sample.wav (Fun-ASR-Nano
    through `run` only), each answer equal to the in-process one."""
    import base64
    import shutil

    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.server.app import clean_asr_response

    tmp = asr["tmp"]
    # the served children run with torch's default flags, under which
    # cuDNN takes TF32 for the encoder's float32 convs; the in-process
    # model they are held to runs with the same (phase_device turned it
    # off for the f32 references)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    runs = contextlib.ExitStack()
    try:
        dirs = _asr_checkpoints(asr, tmp)
        children = {name: runs.enter_context(_run_beside(
            tmp, dirs[name], "--model", model_id, "--input", SAMPLE_WAV,
            "--max-tokens", "16", "--max-seq-len", "2048"))
            for name, model_id in (("qwen3_asr", QWEN3_ASR_MODEL),
                                   ("fun_asr", FUN_ASR_MODEL))}
        served = load_model(QWEN3_ASR_MODEL, dirs["qwen3_asr"],
                            max_seq_len=2048)
        with open(SAMPLE_WAV, "rb") as f:
            wav_data = f.read()
        with runs, _server(dirs["qwen3_asr"], "--model",
                           QWEN3_ASR_MODEL) as base:
            want = served.generate(_asr_request(f"file://{SAMPLE_WAV}",
                                                language="English"))
            want = clean_asr_response(want.choices[0].message.text())
            status, text = _multipart(base + "/v1/audio/transcriptions",
                                      {"language": "en"}, "sample.wav",
                                      wav_data)
            require(status == 200, f"transcription: {text[-500:]}")
            got = json.loads(text)["text"]
            require(got == want, f"transcription {got!r} vs in-process "
                    f"{want!r}")
            log(f"[asr-http] POST /v1/audio/transcriptions (sample.wav, "
                f"language=en): text equal to the in-process reply "
                f"({len(got)} characters)")
            url = "data:audio/wav;base64," + base64.b64encode(
                wav_data).decode()
            body = {"model": QWEN3_ASR_MODEL, "max_tokens": 24,
                    "stream": False, "messages": [{"role": "user",
                                                   "content": [{
                        "type": "audio_url", "audio_url": {"url": url}}]}]}
            want = served.generate(_asr_request(url, 24))
            status, text = _post(base + "/v1/chat/completions", body)
            require(status == 200, f"audio chat: {text[-500:]}")
            got = json.loads(text)
            require(got["choices"][0]["message"]["content"]
                    == want.choices[0].message.content
                    and got["usage"]["prompt_tokens"]
                    == want.usage.prompt_tokens,
                    f"audio chat: {got['choices'][0]['message']['content']!r}"
                    f" vs {want.choices[0].message.content!r}")
            log(f"[asr-http] chat with an audio_url part: "
                f"{got['usage']['prompt_tokens']}-token prompt, reply equal "
                f"to the in-process engine's")
            for name, model_id in (("qwen3_asr", QWEN3_ASR_MODEL),
                                   ("fun_asr", FUN_ASR_MODEL)):
                local = (served if name == "qwen3_asr" else
                         load_model(model_id, dirs[name], max_seq_len=2048))
                want = local.generate(_asr_request(f"file://{SAMPLE_WAV}",
                                                   16))
                lines, secs = _run_lines(children[name], model_id)
                got = "\n".join(lines)
                require(got == want.choices[0].message.text(),
                        f"run {model_id}: {got!r} vs in-process "
                        f"{want.choices[0].message.text()!r}")
                log(f"[asr-http] `run` of {model_id} --input sample.wav "
                    f"answered as the in-process model does ({secs:.1f} s, "
                    f"load included, beside the served child)")
                del local
        del served
    finally:
        runs.close()
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)


# -- 16. VoxCPM text-to-speech: row 8 over a float32 cache --------------------

#: bench.py's VoxCPM prompt (48 ids) and patches (min = max = 25, 80 ms of
#: 16 kHz audio each), 10 CFM steps at cfg 2.0
VOX_IDS = [(i % 1000) + 2 for i in range(48)]
VOX_PATCHES = 25
VOX_STEPS = 10
VOX_MODEL = "OpenBMB/VoxCPM-0.5B"
#: the float32 cache's rows: the prompt, the audio start token, the patches
#: and the reference's 8 spare rows (voxcpm.py's cache_len)
VOX_S = len(VOX_IDS) + 1 + VOX_PATCHES + 8
#: row 8 at VoxCPM-0.5B's float32 caches: the base LM (24 layers) and the
#: residual LM (6), 16 query heads over 2 of 64, every row of the last
#: patch's step live
VOX_DECODE = {"f32": dict(L=24, S=VOX_S, Hq=16, Hkv=2, D=64, valid=VOX_S - 8),
              "f32_residual": dict(L=6, S=VOX_S, Hq=16, Hkv=2, D=64,
                                   valid=VOX_S - 8)}
# the float32 kernel against its plain version on the same float32 inputs,
# relative to max |ref| (f32 sums in another order and the fast exp; the
# cuda tests measure it within 1e-5); a live length off by one moves the
# planted row's weight, most of max |ref|
TOL_DECODE_F32_REL = 1e-5
# (tts): the card's first 3 patches' latents (float32, TF32 off) against
# the same steps on the CPU from the same weights and noise, relative to
# max |ref|: f32 sums in other orders through 30 LM layers and 9 CFM
# evaluations of the 6-layer DiT a patch, fed back patch to patch
TOL_TTS_WITNESS_REL = 1e-3
#: the depth of the served VoxCPM checkpoint (full width): base LM and
#: residual LM layers; the LocEnc and the LocDiT keep theirs
TTS_SERVE = dict(lm=4, residual=2)
#: 16-bit samples two runs on one card may differ by (a rounding flip)
TTS_SAMPLE_STEPS = 1
#: the served checks' text: `run` synthesizes it with the defaults, at
#: most 2 · 6 + 10 = 22 patches (the reference's retry-badcase bound)
TTS_TEXT = "hi"
TTS_READINGS: dict[str, dict] = {}


def check_decode_f32() -> None:
    """Row 8's float32 instance at VoxCPM's two shapes: error against the
    plain version on the first and last layer within TOL_DECODE_F32_REL of
    max |ref|, a live length off by one either way past it; device time
    over the L layers in turn, plain, the bound and masked sdpa over the
    cache's S rows; then a ragged B 2 step (33 and 74 live rows), each slot
    within the bound and bit-equal to a B = 1 launch on it."""
    from aha_tpu_torch.ops import flash_attention as fa

    for i, (key, c) in enumerate(VOX_DECODE.items()):
        L, S, Hq, Hkv, D, valid = (c[n] for n in ("L", "S", "Hq", "Hkv",
                                                  "D", "valid"))
        g = torch.Generator(device="cuda").manual_seed(40 + i)
        q, k, v = _planted_decode_cache(g, L, S, Hq, Hkv, D, valid,
                                        torch.float32)
        vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
        rel, rel_bad, err = 0.0, float("inf"), 0.0
        for li in (0, L - 1):
            lt = torch.tensor(li, dtype=torch.int32, device="cuda")
            ref = fa.flash_decode_at_layer_plain(q, k, v, lt, vl)
            got = fa.flash_decode_at_layer(q, k, v, lt, vl)
            require(got.dtype == torch.float32, "f32 decode returned "
                    f"{got.dtype}")
            e, r = _rel_err(got, ref)
            err, rel = max(err, e), max(rel, r)
            for off in (-1, 1):
                rel_bad = min(rel_bad, _rel_err(fa.flash_decode_at_layer(
                    q, k, v, lt, vl + off), ref)[1])
        require(rel <= TOL_DECODE_F32_REL,
                f"f32 decode {key}: err {rel} of max |ref|")
        require(rel_bad > TOL_DECODE_F32_REL, f"f32 decode {key}: a live "
                f"length off by one stays within the bound ({rel_bad})")
        layer = _layer_cycle(L)
        ms = device_ms(lambda: fa.flash_decode_at_layer(q, k, v, layer(),
                                                        vl), iters=4 * L)
        plain_ms = device_ms(lambda: fa.flash_decode_at_layer_plain(
            q, k, v, layer(), vl), iters=2 * L)
        it = iter(range(10 ** 9))
        kv = [(k[li].transpose(1, 2).contiguous(),
               v[li].transpose(1, 2).contiguous()) for li in range(L)]
        qt = q.transpose(1, 2).contiguous()
        mask = (torch.arange(S, device="cuda") < valid)[None, None, None]
        lib_ms = device_ms(lambda: _sdpa(qt, *kv[next(it) % L],
                                         attn_mask=mask), iters=4 * L)
        b = bound(valid * Hkv * D * 4 * 2 + 2 * Hq * D * 4,
                  4 * Hq * valid * D, "f32")
        log(f"[kernels] flash_decode_at_layer float32 {key} L={L} S={S} "
            f"valid={valid} Hq={Hq} Hkv={Hkv} D={D}: max_abs_err {err:.3e},"
            f" {rel:.3e} of max |ref| (tol {TOL_DECODE_F32_REL}; live length"
            f" ±1 ≥ {rel_bad:.3e}); device ms/call kernel {ms:.4f} plain "
            f"{plain_ms:.4f} masked sdpa {lib_ms:.4f}; bound {b[0]:.5f} "
            f"({b[1]}) | {card_line()}")
        _record("flash_decode_at_layer", err)
        RESULTS["flash_decode_at_layer"][key] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": lib_ms, "rel_err": rel,
            "library": "F.scaled_dot_product_attention, masked, over the "
                       "cache's S rows",
            "timed_at": f"float32 L={L} S={S} valid={valid} Hq={Hq} "
                        f"Hkv={Hkv} D={D}"}
        del q, k, v, kv
    # a ragged B 2 step over the base LM's cache
    L, S, Hq, Hkv, D, lens = 24, VOX_S, 16, 2, 64, (33, VOX_S - 8)
    g = torch.Generator(device="cuda").manual_seed(44)
    q, k, v = _planted_slots_cache(g, L, 2, S, Hq, Hkv, D, lens)
    q, k, v = q.float(), k.float(), v.float()
    vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    lt = torch.tensor(L - 1, dtype=torch.int32, device="cuda")
    got = fa.flash_decode_at_layer(q, k, v, lt, vl)
    ref = fa.flash_decode_at_layer_plain(q, k, v, lt, vl)
    rel = 0.0
    for b_ in range(2):
        one = fa.flash_decode_at_layer(
            q[b_:b_ + 1].contiguous(), k[:, b_:b_ + 1].contiguous(),
            v[:, b_:b_ + 1].contiguous(), lt, vl[b_:b_ + 1].contiguous())
        require(torch.equal(one, got[b_:b_ + 1]), f"f32 decode slot {b_} "
                "differs from a B = 1 launch on it")
        rel = max(rel, _rel_err(got[b_:b_ + 1], ref[b_:b_ + 1])[1])
    bad = _rel_err(fa.flash_decode_at_layer(q, k, v, lt, vl - 1), ref)[1]
    require(rel <= TOL_DECODE_F32_REL < bad, f"f32 decode ragged B 2: err "
            f"{rel} (a length off by one {bad})")
    RESULTS["flash_decode_at_layer"]["f32"]["ragged_b2_rel_err"] = rel
    log(f"[kernels] flash_decode_at_layer float32 ragged B=2 lengths {lens}"
        f" S={S}: {rel:.3e} of max |ref| per slot, each slot bit-equal to a "
        f"B = 1 launch; lengths - 1 off by {bad:.3e}")
    del q, k, v
    torch.cuda.empty_cache()


def voxcpm_0_5b():
    """bench.py's VoxCPM-0.5B geometry: the MiniCPM4-0.5B backbone (24 x
    1024 / 3072, 16/2 heads of 64, vocab 73448, mup, no LongRoPE factors),
    a 6-layer residual LM, the LocEnc 512 x 4 (8 heads), the LocDiT 768 x 6
    (12 heads), feat 64 x patch 2, FSQ 64 at scale 9; the AudioVAE at the
    reference's defaults (encoder 128, rates 2/5/8/8, latent 64, decoder
    1536, 16 kHz)."""
    import dataclasses

    from aha_tpu_torch.models.audio_vae import AudioVAE
    from aha_tpu_torch.models.voxcpm import VoxCPMConfig, VoxLMConfig

    lm = VoxLMConfig(vocab_size=73448, hidden_size=1024,
                     intermediate_size=3072, num_hidden_layers=24,
                     num_attention_heads=16, num_key_value_heads=2)

    def sub(h, ffn, heads, layers):
        return dataclasses.replace(
            lm, hidden_size=h, intermediate_size=ffn,
            num_attention_heads=heads, num_hidden_layers=layers,
            num_key_value_heads=heads, vocab_size=0)

    cfg = VoxCPMConfig(
        architecture="voxcpm", lm=lm, patch_size=2, feat_dim=64,
        sq_latent_dim=64, sq_scale=9, residual_lm_num_layers=6,
        residual_lm_no_rope=False, encoder=sub(512, 2048, 8, 4),
        dit=sub(768, 3072, 12, 6), audio_vae=None, max_length=4096,
        dtype="float32")
    return cfg, AudioVAE()


def _vox_run(model, params, device: str, n: int = VOX_PATCHES,
             seed: int = 0) -> tuple[np.ndarray, float, float]:
    """bench.py's request: the 48-token prompt, min = max = n patches, 10
    CFM steps at cfg 2.0; (latents, wall s, s to the first patch)."""
    ctx = model.build_context(VOX_IDS, None)
    first = []

    def on_patch(i: int) -> None:
        if i == 0:
            _sync(device)
            first.append(time.perf_counter())

    _sync(device)
    t0 = time.perf_counter()
    lat = model.inference(params, *ctx, n, n, VOX_STEPS, 2.0, seed=seed,
                          on_patch=on_patch)
    _sync(device)
    return lat, time.perf_counter() - t0, first[0] - t0


def _vox_step_times(model, params, device: str) -> tuple[float, float]:
    """Device ms (profiler) and wall ms of one decode step after bench's
    prompt: each call rewrites the same cache row (its pos is not
    advanced)."""
    ctx = [torch.as_tensor(np.asarray(a))[None].to(device)
           for a in model.build_context(VOX_IDS, None)]
    T = ctx[0].shape[1]
    cb = model.base_lm.init_cache(1, T + VOX_PATCHES + 8, torch.float32)
    cr = model.residual_lm.init_cache(1, T + VOX_PATCHES + 8, torch.float32)
    with torch.no_grad():
        lm_h, res_h, prev, cb, cr = model.prefill(params, *ctx, cb, cr)
        z = torch.randn(model.noise_shape(), device=device)

        def step():
            return model.decode_step(params, lm_h, res_h, prev, cb, cr, z,
                                     VOX_STEPS, 2.0)

        return device_ms(step, iters=3, warmup=1), _wall_ms(step, device)


def phase_tts(device: str = "cuda") -> dict:
    """(ad) VoxCPM-0.5B at bench.py's geometry, seeded float32 weights as
    the served model loads them: bench's request through `inference` (a
    warm-up of 2 patches first), RTF (80 ms of audio a patch over the
    wall), time to the first patch, ms a patch, row 8's float32 launches
    (30 a patch: 24 base + 6 residual one-row steps), the VAE's decode of
    the 50 latent frames; the first 3 patches' latents against the CPU's
    from the same weights and noise; then the bf16 weights bench.py casts
    to (row 8's bf16 instance), its RTF."""
    from aha_tpu_torch.models.voxcpm import VoxCPMModel

    cfg, vae = voxcpm_0_5b()
    model = VoxCPMModel(cfg, vae.latent_dim, device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator(device=device).manual_seed(0))
    vae_params = vae.init_random(torch.Generator().manual_seed(1),
                                 device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    card = card_line() if device == "cuda" else "cpu"
    lm = cfg.lm
    log(f"[tts] VoxCPM-0.5B geometry: LM {lm.num_hidden_layers} x "
        f"{lm.hidden_size} ({lm.num_attention_heads}/"
        f"{lm.num_key_value_heads} heads of {lm.head_dim}, vocab "
        f"{lm.vocab_size}), residual LM {cfg.residual_lm_num_layers}, LocEnc "
        f"{cfg.encoder.hidden_size} x {cfg.encoder.num_hidden_layers}, LocDiT "
        f"{cfg.dit.hidden_size} x {cfg.dit.num_hidden_layers}, feat "
        f"{cfg.feat_dim} x patch {cfg.patch_size}; {n_params / 1e6:.1f} M "
        f"float32 params and the AudioVAE seeded in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    with torch.no_grad():
        _vox_run(model, params, device, n=2)                # warm-up
        wr = zero_counts()
        lat, wall, ttfp = _vox_run(model, params, device)
        counts = read_counts(wr, "tts", ("flash_decode_at_layer",))
    want = 30 * VOX_PATCHES
    if device == "cuda":
        require(counts["flash_decode_at_layer"] == want,
                f"tts: row 8 launched {counts['flash_decode_at_layer']} "
                f"times, not 30 x {VOX_PATCHES} = {want}")
        RESULTS["flash_decode_at_layer"].setdefault("f32", {})[
            "launches"] = counts["flash_decode_at_layer"]
    P = cfg.patch_size
    require(lat.shape == (VOX_PATCHES * P, vae.latent_dim)
            and np.isfinite(lat).all(), f"tts latents {lat.shape}")
    audio_s = VOX_PATCHES * 0.08
    ms_patch = (wall - ttfp) / (VOX_PATCHES - 1) * 1e3
    z = torch.from_numpy(np.ascontiguousarray(lat.T))[None].to(device)
    with torch.no_grad():
        wav = vae.decode(vae_params, z)
    require(wav.shape == (1, 1, VOX_PATCHES * P * vae.hop_length)
            and bool(torch.isfinite(wav).all()), f"VAE decode {wav.shape}")
    vae_ms = _wall_ms(lambda: vae.decode(vae_params, z), device)
    log(f"[tts] (ad1) {VOX_PATCHES} patches ({audio_s:.1f} s of audio) from "
        f"a {len(VOX_IDS)}-token prompt, {VOX_STEPS} CFM steps: RTF "
        f"{audio_s / wall:.3f} (float32, target >= 1); first patch "
        f"{ttfp * 1e3:.1f} ms, {ms_patch:.2f} ms a patch; row 8 float32 "
        f"{counts['flash_decode_at_layer']} launches (30 a patch); VAE "
        f"decode of {VOX_PATCHES * P} frames {vae_ms:.1f} ms | {card}")
    step_ms = step_wall = None
    if device == "cuda":
        step_ms, step_wall = _vox_step_times(model, params, device)
        log(f"[tts] one patch's step (CFM, LocEnc, 30 LM layers) at the "
            f"prompt's end: {step_ms:.2f} ms device, {step_wall:.2f} ms wall "
            f"(idle share {1 - step_ms / step_wall:.3f}) | {card}")
    # the witness: the first 3 patches on the CPU, the same weights and
    # noise (the loop draws its noise from a CPU generator seeded by seed)
    t0 = time.perf_counter()
    cpu_model = VoxCPMModel(cfg, vae.latent_dim, "cpu")
    cpu_params = _tree_to(params, "cpu", torch.float32)
    with torch.no_grad():
        ref = cpu_model.inference(cpu_params, *cpu_model.build_context(
            VOX_IDS, None), 3, 3, VOX_STEPS, 2.0, seed=0)
    rel = float(np.abs(lat[:3 * P] - ref).max() / np.abs(ref).max())
    require(rel <= TOL_TTS_WITNESS_REL, f"tts: the first 3 patches' latents "
            f"differ from the CPU's by {rel} of max |ref|")
    log(f"[tts] the first 3 patches' latents against the CPU's (float32, the "
        f"same weights and noise): {rel:.3e} of max |ref| (tol "
        f"{TOL_TTS_WITNESS_REL}; {time.perf_counter() - t0:.1f} s)")
    del cpu_params, cpu_model
    # bench.py's bf16 cast: row 8's bf16 instance
    params_bf = _tree_to(params, device, torch.bfloat16)
    with torch.no_grad():
        _vox_run(model, params_bf, device, n=2)
        wr = zero_counts()
        lat_bf, wall_bf, ttfp_bf = _vox_run(model, params_bf, device)
        counts_bf = read_counts(wr, "tts-bf16", ("flash_decode_at_layer",))
    require(device != "cuda" or counts_bf["flash_decode_at_layer"] == want,
            f"tts bf16: row 8 launched {counts_bf['flash_decode_at_layer']}")
    require(np.isfinite(lat_bf).all(), "tts bf16 latents not finite")
    log(f"[tts] (ad2) the same request on bf16 weights (bench.py's cast): RTF"
        f" {audio_s / wall_bf:.3f}; first patch {ttfp_bf * 1e3:.1f} ms, "
        f"{(wall_bf - ttfp_bf) / (VOX_PATCHES - 1) * 1e3:.2f} ms a patch; "
        f"row 8 bf16 {counts_bf['flash_decode_at_layer']} launches | {card}")
    TTS_READINGS.update({
        "f32": {"rtf": audio_s / wall, "wall_s": wall,
                "first_patch_ms": ttfp * 1e3, "ms_per_patch": ms_patch,
                "row8_launches": counts["flash_decode_at_layer"],
                "step_device_ms": step_ms, "step_wall_ms": step_wall,
                "vae_decode_ms": vae_ms, "witness_rel_err": rel},
        "bf16": {"rtf": audio_s / wall_bf, "wall_s": wall_bf,
                 "first_patch_ms": ttfp_bf * 1e3,
                 "ms_per_patch": (wall_bf - ttfp_bf) / (VOX_PATCHES - 1)
                 * 1e3},
        "card": card})
    del params_bf
    return {"cfg": cfg, "vae": vae, "params": params,
            "vae_params": vae_params}


def _char_tokenizer(path: str) -> None:
    """A char-level tokenizer.json (printable ASCII, ids 0-94), as
    tests/test_voxcpm.py's tiny repo has."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {chr(c): i for i, c in enumerate(range(32, 127))}
    vocab["[UNK]"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    tok.save(os.path.join(path, "tokenizer.json"))


def _vox_checkpoint(tts: dict, tmp: str) -> str:
    """TTS_SERVE's cut at full width as VoxCPM-0.5B's files (config.json,
    pytorch_model.bin, audiovae.pth, a char tokenizer) in a directory named
    VoxCPM-0.5B (a name with a 2 would be served as VoxCPM2)."""
    import dataclasses

    from aha_tpu_torch.io.weights import save_hf_voxcpm

    cfg, p, vae = tts["cfg"], tts["params"], tts["vae"]
    n_lm = min(TTS_SERVE["lm"], cfg.lm.num_hidden_layers)
    n_res = min(TTS_SERVE["residual"], cfg.residual_lm_num_layers)
    d = os.path.join(tmp, "VoxCPM-0.5B")
    os.makedirs(d)
    _char_tokenizer(d)

    def block(c):
        return {"hidden_dim": c.hidden_size, "ffn_dim": c.intermediate_size,
                "num_heads": c.num_attention_heads,
                "num_layers": c.num_hidden_layers}

    config = {"architecture": "voxcpm", "patch_size": cfg.patch_size,
              "feat_dim": cfg.feat_dim,
              "scalar_quantization_latent_dim": cfg.sq_latent_dim,
              "scalar_quantization_scale": cfg.sq_scale,
              "residual_lm_num_layers": n_res,
              "residual_lm_no_rope": cfg.residual_lm_no_rope,
              "max_length": cfg.max_length, "dtype": "float32",
              "lm_config": dataclasses.asdict(dataclasses.replace(
                  cfg.lm, num_hidden_layers=n_lm)),
              "encoder_config": block(cfg.encoder),
              "dit_config": block(cfg.dit),
              "audio_vae_config": {
                  "encoder_dim": vae.encoder_dim,
                  "encoder_rates": list(vae.encoder_rates),
                  "latent_dim": vae.latent_dim,
                  "decoder_dim": vae.decoder_dim,
                  "decoder_rates": list(vae.decoder_rates),
                  "sample_rate": vae.sample_rate}}
    cut = {**p, "base_lm": {**p["base_lm"],
                            "layers": p["base_lm"]["layers"][:n_lm]},
           "residual_lm": {**p["residual_lm"],
                           "layers": p["residual_lm"]["layers"][:n_res]}}
    t0 = time.perf_counter()
    save_hf_voxcpm(cut, tts["vae_params"], config, d)
    log(f"[tts-http] full-width checkpoint (LM {n_lm} layers, residual "
        f"{n_res}) written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    return d


def _wav_of(data: bytes) -> np.ndarray:
    """16-bit PCM samples of a WAV file's bytes, as integers."""
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(
            np.int32)


def _same_samples(what: str, got: np.ndarray, want: np.ndarray) -> None:
    diff = (np.abs(got - want).max() if got.shape == want.shape
            and got.size else None)
    require(diff is not None and diff <= TTS_SAMPLE_STEPS,
            f"{what}: {got.shape} samples vs {want.shape}, max step diff "
            f"{diff}")
    log(f"[tts-http] {what}: {got.size} samples equal to the in-process ones"
        f" (max diff {diff} of {TTS_SAMPLE_STEPS} 16-bit steps)")


def phase_http_tts(tts: dict) -> None:
    """TTS_SERVE's checkpoint served by `python -m aha_tpu_torch serv <dir>
    --model OpenBMB/VoxCPM-0.5B` in a child under -X importtime: POST
    /audio/speech (6 patches) returns one audio part whose WAV samples
    equal the in-process served model's for the same request; a streamed
    chat request is refused with the reference's words; then `run` of the
    id with --output writes the WAV of the in-process `synthesize`."""
    import base64
    import shutil

    from aha_tpu_torch.models.loader import load_model
    from aha_tpu_torch.params import ChatCompletionParameters
    from aha_tpu_torch.utils.audio import wav_bytes

    tmp = tempfile.mkdtemp(prefix="aha_torch_tts_")
    # the children run with torch's default cuDNN TF32 for the VAE's
    # convs; the in-process model they are held to runs with it too
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    runs = contextlib.ExitStack()
    try:
        d = _vox_checkpoint(tts, tmp)
        out = os.path.join(tmp, "x.wav")
        child = runs.enter_context(_run_beside(
            tmp, d, "--model", VOX_MODEL, "--input", TTS_TEXT, "--output",
            out))
        served = load_model(VOX_MODEL, d)
        body = {"model": VOX_MODEL, "metadata": {"min_len": "6",
                                                 "max_len": "6"},
                "messages": [{"role": "user", "content": TTS_TEXT}]}
        want = served.generate(ChatCompletionParameters.model_validate(body))
        want_url = want.choices[0].message.content[0].audio_url.url
        with _server(d, "--model", VOX_MODEL) as base:
            status, text = _post(base + "/audio/speech", body)
            require(status == 200, f"/audio/speech: {text[-500:]}")
            parts = json.loads(text)["choices"][0]["message"]["content"]
            require(len(parts) == 1 and parts[0]["type"] == "audio"
                    and parts[0]["audio_url"]["url"].startswith(
                        "data:audio/wav;base64,"), f"parts {str(parts)[:300]}")
            _same_samples("POST /audio/speech (6 patches)", _wav_of(
                base64.b64decode(parts[0]["audio_url"]["url"].split(",")[1])),
                _wav_of(base64.b64decode(want_url.split(",")[1])))
            status, text = _post(base + "/v1/chat/completions",
                                 {**body, "stream": True})
            require("model not support stream" in text,
                    f"a streamed request: {status} {text[-300:]}")
            log("[tts-http] a streamed chat request refused: "
                f"{text.strip()[:120]}")
        want = _wav_of(wav_bytes(served.synthesize(TTS_TEXT),
                                 served.vae.out_sample_rate))
        lines, secs = _run_lines(child, VOX_MODEL)
        require(lines == [f"Output saved to: {out}"], f"run printed {lines}")
        with open(out, "rb") as f:
            got = _wav_of(f.read())
        _same_samples(f"`run --output x.wav` ({secs:.1f} s, load included, "
                      f"beside the served child)", got, want)
        del served
    finally:
        runs.close()
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)


# -- 17. RMBG-2.0 background removal ----------------------------------------

RMBG_MODEL = "AI-ModelScope/RMBG-2.0"
#: the timed forward's side (bench.py's 1024 px) and the witness's
RMBG_SIDE = 1024
RMBG_WITNESS_SIDE = 256
#: the matte of the same weights at 256 px on the card (float32, TF32 off)
#: against the CPU's, relative to max |ref|: f32 sums in other orders
#: through the Swin-L stages, the deformable decoder and the resizes
TOL_RMBG_WITNESS_REL = 1e-3
#: the Swin depths of the served checkpoint (full width, 2 blocks a stage)
RMBG_SERVE_DEPTHS = (2, 2, 2, 2)
#: alpha levels two runs of the served matte may differ by (a uint8
#: truncation flip, spread by the bicubic resize back)
RMBG_ALPHA_LEVELS = 2
RMBG_READINGS: dict[str, dict] = {}


def _captured_calls(module, names: tuple[str, ...], fn):
    """Run fn() with each module function in `names` wrapped to record its
    arguments; {name: [args, ...]}."""
    calls = {n: [] for n in names}
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def rec(*a, **k):
            calls[n].append((a, k))
            return real[n](*a, **k)
        return rec

    for n in names:
        setattr(module, n, wrap(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(module, n, real[n])
    return calls, real


def phase_rmbg(device: str = "cuda") -> dict:
    """(ae) RMBG-2.0 at bench.py's Swin-L defaults (embed 192, depths
    2/2/18/2, heads 6/12/24/48, window 12) and the BiRefNet decoder, seeded
    float32 weights (BiRefNet.init_random): the 1024 px forward's latency
    (median of 3 after a warm-up), its device time, and the device time of
    its Swin window attention (48 calls: both scales) and its deformable
    convs (20 calls), the design candidates; the matte of a 256 px input
    against the CPU's from the same weights."""
    from aha_tpu_torch.models import rmbg2_0 as rm

    cfg = rm.SwinConfig()
    model = rm.BiRefNet(cfg, device)
    t0 = time.perf_counter()
    params = model.init_random(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    card = card_line() if device == "cuda" else "cpu"
    log(f"[rmbg] RMBG-2.0 geometry: Swin (embed {cfg.embed_dim}, depths "
        f"{'/'.join(map(str, cfg.depths))}, heads "
        f"{'/'.join(map(str, cfg.num_heads))}, window {cfg.window_size}) + "
        f"the deformable decoder: {n_params / 1e6:.1f} M float32 params "
        f"seeded in {time.perf_counter() - t0:.1f} s (set-up)")
    side = RMBG_SIDE
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, side, side)).astype(np.float32)).to(device)
    with torch.no_grad():
        out = model.forward(params, x)
        _sync(device)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = model.forward(params, x)
            _sync(device)
            secs.append(time.perf_counter() - t0)
        lat = float(np.median(secs))
        require(out.shape == (1, 1, side, side) and bool(
            torch.isfinite(out).all()) and 0 <= float(out.min())
            and float(out.max()) <= 1, f"matte {tuple(out.shape)}")
        fwd_ms = att_ms = dcn_ms = None
        if device == "cuda":
            fwd_ms = device_ms(lambda: model.forward(params, x), iters=2,
                               warmup=1)
            calls, real = _captured_calls(
                rm, ("_swin_attention", "deform_conv2d"),
                lambda: model.forward(params, x))

            def replay(name):
                for a, k in calls[name]:
                    real[name](*a, **k)

            att_ms = device_ms(lambda: replay("_swin_attention"), iters=2,
                               warmup=1)
            dcn_ms = device_ms(lambda: replay("deform_conv2d"), iters=2,
                               warmup=1)
            n_att, n_dcn = (len(calls[n]) for n in calls)
            del calls
            log(f"[rmbg] (ae1) {side} x {side} forward: {lat * 1e3:.1f} ms wall "
                f"(median of 3), {fwd_ms:.1f} ms device; Swin window "
                f"attention {att_ms:.1f} ms device ({n_att} calls, plain "
                f"einsum + bias), deformable conv {dcn_ms:.1f} ms device "
                f"({n_dcn} calls, plain gathers + einsum) | {card}")
        ws = RMBG_WITNESS_SIDE
        small = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, 3, ws, ws)).astype(np.float32))
        got = model.forward(params, small.to(device)).float().cpu()
    t0 = time.perf_counter()
    cpu_model = rm.BiRefNet(cfg, "cpu")
    with torch.no_grad():
        ref = cpu_model.forward(_tree_to(params, "cpu", torch.float32), small)
    rel = float((got - ref).abs().max() / ref.abs().max())
    require(rel <= TOL_RMBG_WITNESS_REL, f"rmbg: the {ws} px matte differs "
            f"from the CPU's by {rel} of max |ref|")
    log(f"[rmbg] the {ws} px matte against the CPU's (float32, the same "
        f"weights): {rel:.3e} of max |ref| (tol {TOL_RMBG_WITNESS_REL}; "
        f"{time.perf_counter() - t0:.1f} s)")
    RMBG_READINGS.update({"side": side, "latency_ms": lat * 1e3,
                          "forward_device_ms":
                          fwd_ms, "swin_attention_device_ms": att_ms,
                          "deform_conv_device_ms": dcn_ms,
                          "witness_rel_err": rel, "card": card})
    return {"cfg": cfg, "params": params}


def _decoded_png(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    require(img.mode == "RGBA", f"PNG mode {img.mode}")
    return np.asarray(img).astype(np.int32)


def _same_png(what: str, got: bytes, want: bytes) -> None:
    g, w = _decoded_png(got), _decoded_png(want)
    require(g.shape == w.shape and np.array_equal(g[..., :3], w[..., :3]),
            f"{what}: {g.shape} vs {w.shape} or the RGB differs")
    diff = int(np.abs(g[..., 3] - w[..., 3]).max())
    require(diff <= RMBG_ALPHA_LEVELS, f"{what}: alpha off by {diff}")
    log(f"[rmbg-http] {what}: {g.shape[1]} x {g.shape[0]} RGBA, RGB equal, "
        f"alpha within {diff} of {RMBG_ALPHA_LEVELS} levels of the "
        f"in-process PNG")


def phase_http_rmbg(rmbg: dict) -> None:
    """The model cut to RMBG_SERVE_DEPTHS at full width, written with the
    checkpoint's names (io/weights.save_hf_rmbg2_0), served by `python -m
    aha_tpu_torch serv <dir> --model AI-ModelScope/RMBG-2.0` in a child
    under -X importtime: POST /images/remove_background with two images
    returns two image parts, PNGs equal to the in-process served model's;
    then `run` of the id with both inputs and --output writes them."""
    import base64
    import dataclasses
    import shutil

    from aha_tpu_torch.io.weights import save_hf_rmbg2_0
    from aha_tpu_torch.models.loader import load_model

    cfg, p = rmbg["cfg"], rmbg["params"]
    small = dataclasses.replace(cfg, depths=RMBG_SERVE_DEPTHS)
    cut = {**p, "bb": {**p["bb"], "layers": [
        {**lp, "blocks": lp["blocks"][:n]}
        for lp, n in zip(p["bb"]["layers"], RMBG_SERVE_DEPTHS)]}}
    tmp = tempfile.mkdtemp(prefix="aha_torch_rmbg_")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    runs = contextlib.ExitStack()
    try:
        d = os.path.join(tmp, "RMBG-2.0")
        t0 = time.perf_counter()
        save_hf_rmbg2_0(cut, small, d)
        log(f"[rmbg-http] full-width checkpoint (Swin depths "
            f"{RMBG_SERVE_DEPTHS}) written in {time.perf_counter() - t0:.1f}"
            f" s (set-up)")
        urls = [_png_data_url(640, 480, 11), _png_data_url(300, 500, 12)]
        paths = []
        for i, u in enumerate(urls):
            paths.append(os.path.join(tmp, f"in{i}.png"))
            with open(paths[-1], "wb") as f:
                f.write(base64.b64decode(u.split(",", 1)[1]))
        out = os.path.join(tmp, "out.png")
        child = runs.enter_context(_run_beside(
            tmp, d, "--model", RMBG_MODEL, "--input", paths[0], "--input",
            paths[1], "--output", out))
        served = load_model(RMBG_MODEL, d)
        want = served.remove_background(urls)
        body = {"model": RMBG_MODEL, "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": u}} for u in urls]}]}
        with _server(d, "--model", RMBG_MODEL) as base:
            status, text = _post(base + "/images/remove_background", body)
            require(status == 200, f"/images/remove_background: "
                    f"{text[-500:]}")
            parts = json.loads(text)["choices"][0]["message"]["content"]
            require(len(parts) == 2 and all(
                q["type"] == "image" for q in parts), f"{len(parts)} parts")
            for i, (q, w) in enumerate(zip(parts, want)):
                _same_png(f"POST /images/remove_background image {i}",
                          base64.b64decode(q["image_url"]["url"].split(
                              ",", 1)[1]), w)
        lines, secs = _run_lines(child, RMBG_MODEL)
        dests = [os.path.join(tmp, f"out_{i}.png") for i in range(2)]
        require(lines == [f"Output saved to: {x}" for x in dests],
                f"run printed {lines}")
        for i, (x, w) in enumerate(zip(dests, want)):
            with open(x, "rb") as f:
                _same_png(f"`run --output out.png` file out_{i}.png ("
                          f"{secs:.1f} s, load included, beside the served "
                          f"child)", f.read(), w)
        del served
    finally:
        runs.close()
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    timed("kernels", phase_kernels)
    timed("studies", phase_studies)
    from aha_tpu_torch.models.qwen3 import Qwen3Config

    state = timed("engine", phase_engine, Qwen3Config())
    timed("spec", phase_spec, state["model"], state["params"])
    timed("batch", phase_batch, state["model"], state["params"])
    timed("quant", phase_quant, state["model"], state["params"])
    minilm = timed("embed", phase_embed, state["model"], state["params"])
    timed("http", phase_http, state["model"].config, state["params"])
    del state
    torch.cuda.empty_cache()
    minicpm = timed("minicpm", phase_minicpm)
    timed("http-embed", phase_http_embed, minilm, minicpm)
    del minicpm, minilm
    torch.cuda.empty_cache()
    timed("hybrid", phase_hybrid)
    torch.cuda.empty_cache()
    vl = timed("vl", phase_vl)
    vl3 = timed("vl3", phase_vl3)
    timed("vl-http", phase_http_vl, vl["params"], vl3)
    del vl, vl3
    torch.cuda.empty_cache()
    ocr = timed("ocr", phase_ocr)
    lfm2vl = timed("lfm2vl", phase_lfm2vl)
    timed("siglip-http", phase_http_siglip, ocr, lfm2vl)
    del ocr, lfm2vl
    torch.cuda.empty_cache()
    dsocr = timed("dsocr", phase_deepseek_ocr)
    timed("dsocr-http", phase_http_deepseek_ocr, dsocr)
    del dsocr
    torch.cuda.empty_cache()
    asr = timed("asr", phase_asr)
    timed("asr-http", phase_http_asr, asr)
    del asr
    torch.cuda.empty_cache()
    tts = timed("tts", phase_tts)
    timed("tts-http", phase_http_tts, tts)
    del tts
    torch.cuda.empty_cache()
    rmbg = timed("rmbg", phase_rmbg)
    timed("rmbg-http", phase_http_rmbg, rmbg)
    del rmbg
    log(f"[smoke] {time.perf_counter() - t_start:.1f} s in all; by phase "
        f"{json.dumps(secs)}")
    require("jax" not in sys.modules and not any(
        m == "aha_tpu" or m.startswith("aha_tpu.") for m in sys.modules),
        "jax or aha_tpu was imported")
    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                **{k: RESULTS[name][k] for k in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                **{k: RESULTS[name][k] for k in (
                    "library", "timed_at", "launches_by_path",
                    "index_mismatches", "max_abs_err_of", "ms_cast_variant",
                    "also_timed", "full_image", "real_rows_ms", "d72", "k4096",
                    "page", "fun_asr", "ernie", *DSOCR_DECODE, *VOX_DECODE,
                    "weight_gb_s",
                    "g7", "gbps", "tol", "timings", "library_bf16_ms",
                    *SLOT_DECODE_SHAPES)
                   if k in RESULTS[name]}} for name in KERNELS]
    print(json.dumps({"graphs": GRAPH_READINGS}))
    print(json.dumps({"spec": SPEC_READINGS}))
    print(json.dumps({"hybrid": HYBRID_READINGS}))
    print(json.dumps({"vl3": VL3_READINGS}))
    print(json.dumps({"siglip": SIGLIP_READINGS}))
    print(json.dumps({"dsocr": DSOCR_READINGS}))
    print(json.dumps({"asr": ASR_READINGS}))
    print(json.dumps({"tts": TTS_READINGS}))
    print(json.dumps({"rmbg": RMBG_READINGS}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
