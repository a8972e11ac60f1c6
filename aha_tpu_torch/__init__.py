"""aha_tpu_torch: the Qwen3 text-chat path of aha_tpu in PyTorch + CUDA.

A second package beside the JAX one (`aha_tpu`, the numerics reference).
The device path — `ops/`, `core/cache.py`, `core/nn.py`,
`core/sampling.py`, `core/engine.py` (one stream), `core/batch_engine.py`
(continuous batching), `models/qwen3.py` — is PyTorch with hand-written
CUDA kernels for Hopper (`csrc/*.cu`): the fused decode stack, decode
attention over the stacked flat KV cache (one slot or a batch of slots),
decode attention over the int8 cache, prefill flash attention, and the
fused LM-head GEMV + argmax.  On a CPU tensor every kernel wrapper runs its
plain PyTorch version instead, which is what the CPU tests exercise.

The host layer (served model, HTTP server, CLI) reuses the jax-free host
modules of `aha_tpu` (params, registry, tokenizer, chat template, server
handlers).  `aha_tpu`'s package `__init__` imports jax for its compile
cache unless `AHA_NO_COMPILE_CACHE=1`; the port's CLI sets it.
"""

__version__ = "0.1.0"
