"""AudioVAE: the DAC-like causal conv VAE of VoxCPM's latents (counterpart
of aha_tpu/models/audio_vae.py, the same names and parameter tree).

- causal convs (ops/conv.py): left-pad 2·p then VALID; the transpose conv
  keeps its first out − (2·p − output_padding) samples;
- weight norm w = g · v/‖v‖ (the norm over all dims but 0), folded once at
  load, so the forward is plain convs;
- Snake1d: x + sin(αx)² / (α + 1e-9);
- residual unit: snake → depthwise k 7 conv at dilation 1, 3 or 9 → snake
  → 1×1 conv, the residual trimmed to match;
- encoder: stem k 7 → per rate (2, 5, 8, 8) three residual units, snake,
  a strided k 2s conv doubling the channels → fc_mu (encode returns mu);
- decoder: depthwise k 7 stem → 1×1 to decoder_dim → per rate (8, 8, 5, 2)
  optional sample-rate scale / bias embeddings (`sr_bin_boundaries`),
  snake, transpose conv k 2s halving the channels, three residual units →
  snake → k 7 → tanh.

The convolutions are `F.conv1d` / `F.conv_transpose1d` (the reference
computes them in XLA, outside any Pallas kernel), in the input's dtype;
`init_random` draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aha_tpu_torch.ops.conv import causal_conv1d, causal_conv_transpose1d

DILATIONS = (1, 3, 9)


def fold_weight_norm(weight_v: torch.Tensor,
                     weight_g: torch.Tensor) -> torch.Tensor:
    """g · v/‖v‖ with the norm over all dims but 0."""
    norm = weight_v.square().sum(dim=(1, 2), keepdim=True).sqrt()
    return weight_v / norm * weight_g


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin(αx)² / (α + 1e-9); alpha (1, C, 1)."""
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def _residual_unit(p: dict, x: torch.Tensor, dilation: int,
                   groups: int) -> torch.Tensor:
    y = snake(x, p["a0"])
    y = causal_conv1d(y, p["w1"], p.get("b1"), dilation=dilation,
                      groups=groups, padding=(7 - 1) * dilation // 2)
    y = snake(y, p["a2"])
    y = causal_conv1d(y, p["w3"], p.get("b3"))
    trim = (x.shape[-1] - y.shape[-1]) // 2
    res = x[..., trim:trim + y.shape[-1]] if trim > 0 else x
    return y + res


class AudioVAE:
    def __init__(self, encoder_dim: int = 128,
                 encoder_rates=(2, 5, 8, 8), latent_dim: int = 64,
                 decoder_dim: int = 1536, decoder_rates=(8, 8, 5, 2),
                 sample_rate: int = 16000, out_sample_rate: int | None = None,
                 sr_bin_boundaries=None):
        self.encoder_dim = encoder_dim
        self.encoder_rates = tuple(encoder_rates)
        self.latent_dim = latent_dim
        self.decoder_dim = decoder_dim
        self.decoder_rates = tuple(decoder_rates)
        self.hop_length = int(np.prod(encoder_rates))
        self.chunk_size = self.hop_length
        self.sample_rate = sample_rate
        self.out_sample_rate = out_sample_rate or sample_rate
        self.sr_bin_boundaries = sr_bin_boundaries

    @classmethod
    def from_config(cls, d: dict | None) -> "AudioVAE":
        d = d or {}
        return cls(encoder_dim=d.get("encoder_dim", 128),
                   encoder_rates=d.get("encoder_rates", (2, 5, 8, 8)),
                   latent_dim=d.get("latent_dim", 64),
                   decoder_dim=d.get("decoder_dim", 1536),
                   decoder_rates=d.get("decoder_rates", (8, 8, 5, 2)),
                   sample_rate=d.get("sample_rate", 16000),
                   out_sample_rate=d.get("out_sample_rate"),
                   sr_bin_boundaries=d.get("sr_bin_boundaries"))

    # -- forward ---------------------------------------------------------------

    def encode(self, params: dict, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, 1, T) → mu (B, latent_dim, T / hop); T padded up to a
        multiple of hop_length."""
        pad = (-audio.shape[-1]) % self.hop_length
        if pad:
            audio = torch.nn.functional.pad(audio, (0, pad))
        ep = params["encoder"]
        x = causal_conv1d(audio, ep["stem"]["w"], ep["stem"].get("b"),
                          padding=3)
        d = self.encoder_dim
        for i, stride in enumerate(self.encoder_rates):
            bp = ep["blocks"][i]
            for j, dil in enumerate(DILATIONS):
                x = _residual_unit(bp["units"][j], x, dil, d)
            x = snake(x, bp["a"])
            x = causal_conv1d(x, bp["down"]["w"], bp["down"].get("b"),
                              stride=stride, padding=math.ceil(stride / 2))
            d *= 2
        return causal_conv1d(x, ep["fc_mu"]["w"], ep["fc_mu"].get("b"),
                             padding=1)

    def sr_index(self, sr_cond: int | None = None) -> int | None:
        """The decoder's sample-rate embedding row (searchsorted left of
        the boundaries), None without boundaries."""
        if self.sr_bin_boundaries is None:
            return None
        sr = sr_cond if sr_cond is not None else self.out_sample_rate
        return int(np.searchsorted(np.asarray(self.sr_bin_boundaries), sr,
                                   side="left"))

    def decode(self, params: dict, z: torch.Tensor,
               sr_cond: int | None = None) -> torch.Tensor:
        """z (B, latent_dim, T') → waveform (B, 1, T'·hop)."""
        dp = params["decoder"]
        x = causal_conv1d(z, dp["stem"]["w"], dp["stem"].get("b"),
                          groups=self.latent_dim, padding=3)
        x = causal_conv1d(x, dp["in"]["w"], dp["in"].get("b"))
        sr_idx = self.sr_index(sr_cond)
        for i, stride in enumerate(self.decoder_rates):
            bp = dp["blocks"][i]
            out_dim = self.decoder_dim // (2 ** (i + 1))
            if sr_idx is not None and "sr_scale" in bp:
                x = (x * bp["sr_scale"][sr_idx][None, :, None]
                     + bp["sr_bias"][sr_idx][None, :, None])
            x = snake(x, bp["a"])
            x = causal_conv_transpose1d(
                x, bp["up"]["w"], bp["up"].get("b"), stride=stride,
                padding=math.ceil(stride / 2), output_padding=stride % 2)
            for j, dil in enumerate(DILATIONS):
                x = _residual_unit(bp["units"][j], x, dil, out_dim)
        x = snake(x, dp["a_out"])
        x = causal_conv1d(x, dp["out"]["w"], dp["out"].get("b"), padding=3)
        return torch.tanh(x)

    # -- loading -----------------------------------------------------------------

    @staticmethod
    def _wn_conv(src, name: str, device, dtype) -> dict:
        v = src[name + ".weight_v"].float()
        g = src[name + ".weight_g"].float()
        out = {"w": fold_weight_norm(v, g).to(device=device, dtype=dtype)}
        if name + ".bias" in src:
            out["b"] = src[name + ".bias"].to(device=device, dtype=dtype)
        return out

    def _unit(self, src, name: str, device, dtype) -> dict:
        def get(n):
            return src[n].to(device=device, dtype=dtype)

        p = {"a0": get(name + ".block.0.alpha"),
             "a2": get(name + ".block.2.alpha"),
             "w1": self._wn_conv(src, name + ".block.1", device, dtype)["w"],
             "w3": self._wn_conv(src, name + ".block.3", device, dtype)["w"]}
        for k, n in (("b1", ".block.1.bias"), ("b3", ".block.3.bias")):
            if name + n in src:
                p[k] = get(name + n)
        return p

    def load_params(self, src, device="cpu", dtype=torch.float32,
                    prefix: str = "") -> dict:
        """The tree from a checkpoint's weight-normed names (`.pth`), the
        norms folded here."""
        def get(n):
            return src[n].to(device=device, dtype=dtype)

        def wn(n):
            return self._wn_conv(src, n, device, dtype)

        enc_blocks = []
        for i in range(len(self.encoder_rates)):
            base = f"{prefix}encoder.block.{i + 1}"
            enc_blocks.append({
                "units": [self._unit(src, f"{base}.block.{j}", device, dtype)
                          for j in range(3)],
                "a": get(f"{base}.block.3.alpha"),
                "down": wn(f"{base}.block.4"),
            })
        dec_blocks = []
        for i in range(len(self.decoder_rates)):
            base = f"{prefix}decoder.model.{i + 2}"
            bp = {"a": get(f"{base}.block.0.alpha"),
                  "up": wn(f"{base}.block.1"),
                  "units": [self._unit(src, f"{base}.block.{j + 2}", device,
                                       dtype) for j in range(3)]}
            sr_name = f"{prefix}decoder.sr_cond_model.{i + 2}"
            if f"{sr_name}.scale_embed.weight" in src:
                bp["sr_scale"] = get(f"{sr_name}.scale_embed.weight")
                bp["sr_bias"] = get(f"{sr_name}.bias_embed.weight")
            dec_blocks.append(bp)
        n_up = len(self.decoder_rates)
        return {
            "encoder": {"stem": wn(f"{prefix}encoder.block.0"),
                        "blocks": enc_blocks,
                        "fc_mu": wn(f"{prefix}encoder.fc_mu")},
            "decoder": {"stem": wn(f"{prefix}decoder.model.0"),
                        "in": wn(f"{prefix}decoder.model.1"),
                        "blocks": dec_blocks,
                        "a_out": get(f"{prefix}decoder.model.{n_up + 2}.alpha"),
                        "out": wn(f"{prefix}decoder.model.{n_up + 3}")},
        }

    def init_random(self, generator: torch.Generator, scale: float = 0.1,
                    device="cpu", dtype=torch.float32) -> dict:
        """Seeded weights of the JAX tree's shapes (N(0, scale) convs, zero
        biases, unit alphas), drawn on the CPU from `generator`."""
        def w(*shape):
            return (torch.randn(shape, generator=generator) * scale).to(
                device=device, dtype=dtype)

        def ones(*shape):
            return torch.ones(shape, device=device, dtype=dtype)

        def zeros(n):
            return torch.zeros(n, device=device, dtype=dtype)

        def unit(dim, groups):
            return {"a0": ones(1, dim, 1), "a2": ones(1, dim, 1),
                    "w1": w(dim, dim // groups, 7), "b1": zeros(dim),
                    "w3": w(dim, dim, 1), "b3": zeros(dim)}

        d = self.encoder_dim
        enc_blocks = []
        for stride in self.encoder_rates:
            enc_blocks.append({"units": [unit(d, d) for _ in range(3)],
                               "a": ones(1, d, 1),
                               "down": {"w": w(2 * d, d, 2 * stride),
                                        "b": zeros(2 * d)}})
            d *= 2
        dec_blocks = []
        cin = self.decoder_dim
        for stride in self.decoder_rates:
            cout = cin // 2
            dec_blocks.append({"a": ones(1, cin, 1),
                               "up": {"w": w(cin, cout, 2 * stride),
                                      "b": zeros(cout)},
                               "units": [unit(cout, cout) for _ in range(3)]})
            cin = cout
        return {
            "encoder": {"stem": {"w": w(self.encoder_dim, 1, 7),
                                 "b": zeros(self.encoder_dim)},
                        "blocks": enc_blocks,
                        "fc_mu": {"w": w(self.latent_dim, d, 3),
                                  "b": zeros(self.latent_dim)}},
            "decoder": {"stem": {"w": w(self.latent_dim, 1, 7),
                                 "b": zeros(self.latent_dim)},
                        "in": {"w": w(self.decoder_dim, self.latent_dim, 1),
                               "b": zeros(self.decoder_dim)},
                        "blocks": dec_blocks,
                        "a_out": ones(1, cin, 1),
                        "out": {"w": w(1, cin, 7), "b": zeros(1)}},
        }
