"""VoxCPM served model: /audio/speech and the chat endpoint → a WAV data
URL (counterpart of aha_tpu/models/voxcpm_served.py).

- metadata knobs: prompt_text, control_instruction, min_len (2), max_len
  (4096), inference_timesteps (10), cfg_value (2.0),
  retry_badcase_ratio_threshold (6.0);
- a voice-clone prompt wav through an audio_url part; a prompt wav
  without prompt_text on a model that is not VoxCPM2 is refused
  ("reference mode is only supported with VoxCPM2 models");
- VoxCPM2's control_instruction prefixes the target text "(...)";
- the reply: one assistant message with a single {type: "audio",
  audio_url: {url: "data:audio/wav;base64,..."}} part;
- streaming is refused ("{name} model not support stream");
- the VAE loads from *.pth, the model from *.bin (0.5B) or *.safetensors
  (1.5 / 2) in the same directory, both in float32 as the reference loads
  them (the LM / DiT stack is small and the CFM precision-sensitive), on
  the port's device: the card unless AHA_DEVICE asks for the CPU.
"""

from __future__ import annotations

import base64
import glob
import os
import uuid

import numpy as np
import torch

from aha_tpu_torch.io.weights import SafetensorsSource, TorchPickleSource
from aha_tpu_torch.models.audio_vae import AudioVAE
from aha_tpu_torch.models.base import LoadedModel, UnsupportedOperation
from aha_tpu_torch.models.voxcpm import (SingleChineseTokenizer,
                                         VoxCPMConfig, VoxCPMModel)
from aha_tpu_torch.params import (ChatCompletionChoice,
                                  ChatCompletionParameters,
                                  ChatCompletionResponse, ChatMessage,
                                  extract_parts)
from aha_tpu_torch.params.chat import AudioUrl, ContentPart, now_created
from aha_tpu_torch.registry import ModelEntry
from aha_tpu_torch.utils.device import device

#: samples trimmed from each end of the decoded waveform (the causal
#: convs' warm-up margin), when it is longer than twice that
TRIM = 640


def _extract_user_text(mes: ChatCompletionParameters) -> str:
    texts = [m.text() for m in mes.messages if m.role == "user"]
    return "\n".join(t for t in texts if t)


class VoxCPMServed(LoadedModel):
    def __init__(self, entry: ModelEntry, config: VoxCPMConfig,
                 model: VoxCPMModel, params: dict, vae: AudioVAE,
                 vae_params: dict, tokenizer: SingleChineseTokenizer,
                 model_name: str):
        super().__init__(entry)
        self.config = config
        self.model = model
        self.params = params
        self.vae = vae
        self.vae_params = vae_params
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.device = model.device

    @classmethod
    def load(cls, entry: ModelEntry, path: str, **kw) -> "VoxCPMServed":
        dev = device()
        config = VoxCPMConfig.from_file(path)
        vae = AudioVAE.from_config(config.audio_vae)
        pth = sorted(glob.glob(os.path.join(path, "*.pth")))
        st = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        bins = sorted(glob.glob(os.path.join(path, "*.bin")))
        pth_src = TorchPickleSource(pth) if pth else None
        if bins:
            model_src = TorchPickleSource(bins)
        elif st:
            model_src = SafetensorsSource(st)
        else:
            model_src = pth_src
        model = VoxCPMModel(config, vae.latent_dim, device=dev)
        params = model.load_params(model_src, dtype=torch.float32)
        vae_params = vae.load_params(pth_src or model_src, device=dev,
                                     dtype=torch.float32)
        name = os.path.basename(path.rstrip("/")) or entry.name
        return cls(entry, config, model, params, vae, vae_params,
                   SingleChineseTokenizer(path), name)

    # -- audio -------------------------------------------------------------------

    def _encode_prompt_wav(self, source: str, pad_left: bool) -> np.ndarray:
        """A prompt wav → (T_patches, patch_size, latent) latents: padded to
        a whole patch, VAE-encoded, regrouped."""
        from aha_tpu_torch.utils.audio import prepare_audio

        wav = prepare_audio(source, self.vae.sample_rate)
        patch_len = self.config.patch_size * self.vae.chunk_size
        pad = (-len(wav)) % patch_len
        if pad:
            zeros = np.zeros(pad, np.float32)
            wav = (np.concatenate([zeros, wav]) if pad_left
                   else np.concatenate([wav, zeros]))
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32))
        with torch.no_grad():
            mu = self.vae.encode(self.vae_params,
                                 x[None, None].to(self.device))
        mu = mu[0].float().cpu().numpy()                # (latent, T')
        D, P = self.vae.latent_dim, self.config.patch_size
        return mu.reshape(D, -1, P).transpose(1, 2, 0)  # (T, P, D)

    def decode_latents(self, latents: np.ndarray) -> np.ndarray:
        """(T·P, latent) latents → the float32 waveform at
        out_sample_rate, TRIM samples cut from each end."""
        z = torch.from_numpy(np.ascontiguousarray(latents.T, np.float32))
        with torch.no_grad():
            wav = self.vae.decode(self.vae_params, z[None].to(self.device))
        wav = wav[0, 0].float().cpu().numpy()
        if len(wav) > 2 * TRIM:
            wav = wav[TRIM:len(wav) - TRIM]
        return wav.astype(np.float32)

    def synthesize(self, target_text: str, prompt_text: str | None = None,
                   prompt_wav: str | None = None, min_len: int = 2,
                   max_len: int = 4096, inference_timesteps: int = 10,
                   cfg_value: float = 2.0, ratio_threshold: float = 6.0,
                   seed: int = 0, noise=None) -> np.ndarray:
        """The whole pipeline → a float32 waveform at out_sample_rate.
        `noise` (per patch, (1, latent, P)) replaces the seeded draws."""
        if prompt_text is not None and prompt_wav is not None:
            ids = self.tokenizer.encode(prompt_text + target_text)
            feat = self._encode_prompt_wav(prompt_wav, pad_left=True)
        else:
            ids = self.tokenizer.encode(target_text)
            feat = (self._encode_prompt_wav(prompt_wav, pad_left=False)
                    if prompt_wav else None)
        tt, tm, af, am = self.model.build_context(ids, feat)
        n_target = len(self.tokenizer.encode(target_text))
        max_len = min(max_len, int(n_target * ratio_threshold + 10))
        latents = self.model.inference(self.params, tt, tm, af, am, min_len,
                                       max_len, inference_timesteps,
                                       cfg_value, seed=seed, noise=noise)
        return self.decode_latents(latents)

    # -- LoadedModel -------------------------------------------------------------

    def generate(self, mes: ChatCompletionParameters
                 ) -> ChatCompletionResponse:
        from aha_tpu_torch.utils.audio import wav_bytes

        def meta(key, cast, default):
            v = mes.metadata_value(key)
            return cast(v) if v is not None else default

        prompt_text = mes.metadata_value("prompt_text")
        control = mes.metadata_value("control_instruction")
        min_len = meta("min_len", int, 2)
        max_len = meta("max_len", int, 4096)
        steps = meta("inference_timesteps", int, 10)
        cfg_value = meta("cfg_value", float, 2.0)
        ratio = meta("retry_badcase_ratio_threshold", float, 6.0)

        wavs = [p.audio_url.url for m in mes.messages
                for p in extract_parts(m.content, "audio_url")]
        prompt_wav = wavs[0] if wavs else None
        is_v2 = "2" in self.model_name
        if not is_v2 and prompt_wav is not None and prompt_text is None:
            raise UnsupportedOperation(
                "reference mode is only supported with VoxCPM2 models")
        target = _extract_user_text(mes)
        if control and is_v2:
            target = f"({control}){target}"

        wav = self.synthesize(target, prompt_text, prompt_wav, min_len,
                              max_len, steps, cfg_value, ratio,
                              seed=mes.seed or 0)
        b64 = base64.b64encode(
            wav_bytes(wav, self.vae.out_sample_rate)).decode()
        part = ContentPart(type="audio", audio_url=AudioUrl(
            url=f"data:audio/wav;base64,{b64}"))
        return ChatCompletionResponse(
            id=str(uuid.uuid4()),
            choices=[ChatCompletionChoice(
                index=0,
                message=ChatMessage(role="assistant", content=[part]))],
            created=now_created(), model=self.model_name,
            object="chat.completion")

    def generate_stream(self, mes: ChatCompletionParameters):
        raise UnsupportedOperation(
            f"{self.model_name} model not support stream")
