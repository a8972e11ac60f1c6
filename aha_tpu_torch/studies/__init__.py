"""H100 design studies: the port of the TPU design studies under `scripts/`.

Each module mirrors a script by file name and runs that script's
candidates on the card at the script's full geometry, as hand-written CUDA
kernels (`csrc/study_*.cu`) beside their plain PyTorch versions:

    python -m aha_tpu_torch.studies.exp_gemv          # read ceiling, M = 8 GEMV, argmax head
    python -m aha_tpu_torch.studies.exp_int4          # int4 weights on mma.sync: k8 words (two ways), packed
    python -m aha_tpu_torch.studies.exp_fused_layer   # one launch per layer, box and ring sweep

and one study of the port's own bf16 decode stack, `stack_parts` (its
grid barriers alone, its weight stream without them, the stack):

    python -m aha_tpu_torch.studies.stack_parts

`--quick` runs each kernel's default variant only.  Every wrapper counts
its launches (`<wrapper>.launches`), runs its plain version on a CPU tensor
and launches its kernel (or raises) on a CUDA one.  Nothing here is on a
serving path.  Each `main()` prints the card's name and power limit first,
then per kernel: device time (profiler), GB/s of the bytes it must move,
its bound, the plain version's time and a library yardstick where one
PyTorch call computes the same function; the last line is JSON.
"""

from __future__ import annotations

import json
import subprocess

import torch

#: the H100 SXM's published rates (NVIDIA data sheet, dense): HBM bytes/s
#: and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float = 0.0, kind: str = "bf16"
          ) -> tuple[float, str]:
    """The least time (ms) the card could take: the bytes over the HBM
    rate or the operations over the peak for their type, the larger."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, iters: int = 30, warmup: int = 3, key: str = "") -> float:
    """Device ms per call of `fn`: the summed profiler time of the CUDA
    kernels it launches (only those whose name holds `key`, if given)."""
    from aha_tpu_torch.utils.profile_decode import device_ms_per_kernel

    per = device_ms_per_kernel(fn, iters, warmup)
    ms = sum(v for k, v in per.items() if key in k)
    if ms <= 0:
        raise RuntimeError(f"the profiler saw no device time ({key or 'any'})")
    return ms


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the studies run on a CUDA card; torch sees none")
    # f32 references are true f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, the same relative to max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def report(rows: list[dict]) -> None:
    """One readable line per measured kernel, then the rows as JSON."""
    for r in rows:
        extra = "".join(f" {k} {r[k]:.4f}" for k in
                        ("plain_ms", "library_ms", "library_bf16_ms")
                        if r.get(k) is not None)
        print(f"[{r['name']}{' ' + r['variant'] if r.get('variant') else ''}]"
              f" {r['ms']:.4f} ms, {r['gbps']:.1f} GB/s; bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']});{extra}; max_abs_err "
              f"{r['max_abs_err']:.3e}", flush=True)
    print(json.dumps({"rows": rows}), flush=True)
