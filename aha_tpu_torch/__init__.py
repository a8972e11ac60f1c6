"""aha_tpu_torch: the Qwen3 text-chat path of aha_tpu in PyTorch + CUDA.

A second package beside the JAX one (`aha_tpu`, the numerics reference).
The device path — `ops/`, `core/cache.py`, `core/nn.py`,
`core/sampling.py`, `core/engine.py` (one stream), `core/batch_engine.py`
(continuous batching), `models/qwen3.py` — is PyTorch with hand-written
CUDA kernels for Hopper (`csrc/*.cu`): the fused decode stack, decode
attention over the stacked flat KV cache (one slot or a batch of slots),
decode attention over the int8 cache, prefill flash attention, the fused
LM-head GEMV + argmax (bf16, int8 and 4-bit heads), and the GGUF grids'
quantized matmuls and fused quantized SwiGLU.  On a CPU tensor every
kernel wrapper runs its plain PyTorch version instead, which is what the
CPU tests exercise.

The host layer (served model, HTTP server, CLI) and the GGUF reader are
the port's own copies of aha_tpu's host modules (params, registry,
tokenizer, chat template, server handlers, io/gguf.py): the port imports
nothing of `aha_tpu`.
"""

__version__ = "0.1.0"
