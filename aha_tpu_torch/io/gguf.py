"""GGUF reader and writer (the port's copy of aha_tpu/io/gguf.py):
header/metadata/tensor parsing, block dequantization, tokenizer
reconstruction from embedded metadata, and the quantizers and minimal
writer that tests and chip_smoke.py make files with.

Equivalent of src/models/common/gguf.rs: the candle gguf wrapper (:19-116)
and the BPE-tokenizer-from-metadata path (:117-206).  Written from the GGUF
v3 spec; no external gguf package.

Dequantization covers F32/F16/BF16, Q8_0, Q4_0, Q4_1, Q5_0, IQ4_NL, Q2_K,
Q3_K, Q4_K, Q5_K and Q6_K.  A block type goes first through the C++ host
dequant (aha_tpu_torch/native, the port's copy of aha_tpu/native), then, where
that is unavailable, through vectorized numpy over the memory-mapped file:
the JAX reader's own numpy reference.  `DEQUANT_PATHS` counts the block
tensors each path dequantized in this process.
"""

from __future__ import annotations

import mmap
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF"

# ggml tensor type ids
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_IQ4_NL = 20
GGML_BF16 = 30

_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
    GGML_Q8_0: "Q8_0", GGML_Q4_K: "Q4_K", GGML_Q6_K: "Q6_K",
    GGML_IQ4_NL: "IQ4_NL",
    GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q5_K: "Q5_K",
}

# (block_elems, block_bytes)
_BLOCK = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20), GGML_Q5_0: (32, 22),
    GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144), GGML_Q6_K: (256, 210),
    GGML_IQ4_NL: (32, 18),
    GGML_Q2_K: (256, 84), GGML_Q3_K: (256, 110), GGML_Q5_K: (256, 176),
}

IQ4_NL_KVALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    np.float32)

# GGUF metadata value types
_V_U8, _V_I8, _V_U16, _V_I16, _V_U32, _V_I32 = 0, 1, 2, 3, 4, 5
_V_F32, _V_BOOL, _V_STR, _V_ARR, _V_U64, _V_I64, _V_F64 = 6, 7, 8, 9, 10, 11, 12


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # logical shape, row-major (numpy order)
    ggml_type: int
    offset: int  # relative to data section start

    @property
    def type_name(self) -> str:
        return _TYPE_NAMES.get(self.ggml_type, str(self.ggml_type))


class GGUFFile:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata: dict[str, object] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._parse()

    # -- parsing ------------------------------------------------------------

    def _parse(self) -> None:
        mm = self._mm
        self._pos = 0

        def u32():
            v = struct.unpack_from("<I", mm, self._pos)[0]
            self._pos += 4
            return v

        def u64():
            v = struct.unpack_from("<Q", mm, self._pos)[0]
            self._pos += 8
            return v

        def read_str():
            n = u64()
            s = mm[self._pos:self._pos + n].decode("utf-8", errors="replace")
            self._pos += n
            return s

        def read_value(vtype):
            if vtype == _V_STR:
                return read_str()
            if vtype == _V_ARR:
                at = u32()
                n = u64()
                return [read_value(at) for _ in range(n)]
            fmt = {_V_U8: "<B", _V_I8: "<b", _V_U16: "<H", _V_I16: "<h",
                   _V_U32: "<I", _V_I32: "<i", _V_F32: "<f", _V_BOOL: "<?",
                   _V_U64: "<Q", _V_I64: "<q", _V_F64: "<d"}[vtype]
            v = struct.unpack_from(fmt, mm, self._pos)[0]
            self._pos += struct.calcsize(fmt)
            return v

        magic = u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: magic {magic:#x}")
        version = u32()
        if version < 2:
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = u64()
        n_kv = u64()
        for _ in range(n_kv):
            key = read_str()
            vtype = u32()
            self.metadata[key] = read_value(vtype)

        infos = []
        for _ in range(n_tensors):
            name = read_str()
            n_dims = u32()
            # GGUF dims are innermost-first; reverse → numpy row-major shape
            dims = [u64() for _ in range(n_dims)]
            ggml_type = u32()
            offset = u64()
            infos.append(GGUFTensorInfo(name, tuple(reversed(dims)),
                                        ggml_type, offset))

        alignment = int(self.metadata.get("general.alignment", 32))
        self.data_start = (self._pos + alignment - 1) // alignment * alignment
        for info in infos:
            self.tensors[info.name] = info

    # -- raw access ---------------------------------------------------------

    def tensor_bytes(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        n_elems = int(np.prod(info.shape))
        be, bb = _BLOCK[info.ggml_type]
        nbytes = n_elems // be * bb
        start = self.data_start + info.offset
        return np.frombuffer(self._mm, np.uint8, nbytes, start)

    # -- dequantization -----------------------------------------------------

    def dequantize(self, name: str, dtype=np.float32) -> np.ndarray:
        info = self.tensors[name]
        raw = self.tensor_bytes(name)
        out = _dequant(raw, info.ggml_type)
        return out.reshape(info.shape).astype(dtype)

    def keys(self) -> list[str]:
        return list(self.tensors.keys())

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    # -- tokenizer reconstruction (gguf.rs:117-206) --------------------------

    def build_tokenizer(self):
        from tokenizers import AddedToken, Tokenizer, decoders, pre_tokenizers
        from tokenizers.models import BPE

        model_type = self.metadata.get("tokenizer.ggml.model")
        if model_type not in ("gpt2", "llama"):
            raise ValueError(f"unsupported gguf tokenizer model {model_type}")
        tokens = self.metadata["tokenizer.ggml.tokens"]
        vocab = {tok: i for i, tok in enumerate(tokens)}
        merges = []
        for m in self.metadata.get("tokenizer.ggml.merges", []):
            parts = m.split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        tok = Tokenizer(BPE(vocab, merges))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(
            add_prefix_space=False, trim_offsets=False, use_regex=False)
        tok.decoder = decoders.ByteLevel()
        token_types = self.metadata.get("tokenizer.ggml.token_type")
        if token_types:
            # type 3 == CONTROL → special token; type 4 == USER_DEFINED →
            # non-special added token, still encoded atomically (matches the
            # reference's gguf build_tokenizer)
            specials = [AddedToken(t, special=True, normalized=False)
                        for t, ty in zip(tokens, token_types) if ty == 3]
            if specials:
                tok.add_special_tokens(specials)
            user_defined = [AddedToken(t, special=False, normalized=False)
                            for t, ty in zip(tokens, token_types) if ty == 4]
            if user_defined:
                tok.add_tokens(user_defined)
        return tok

    def chat_template(self) -> str | None:
        return self.metadata.get("tokenizer.chat_template")

    def eos_token_id(self) -> int | None:
        v = self.metadata.get("tokenizer.ggml.eos_token_id")
        return int(v) if v is not None else None


# ---------------------------------------------------------------------------
# Block dequant kernels (vectorized numpy)
# ---------------------------------------------------------------------------


def _f16(raw_u8: np.ndarray) -> np.ndarray:
    return raw_u8.view(np.float16).astype(np.float32)


def _unpack_k4_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12 packed bytes → 8 six-bit (scale, min) pairs (get_scale_min_k4,
    shared by Q4_K and Q5_K)."""
    nb = scales.shape[0]
    sc = np.zeros((nb, 8), np.float32)
    mn = np.zeros((nb, 8), np.float32)
    for j in range(8):
        if j < 4:
            sc[:, j] = scales[:, j] & 63
            mn[:, j] = scales[:, j + 4] & 63
        else:
            sc[:, j] = (scales[:, j + 4] & 0x0F) | ((scales[:, j - 4] >> 6) << 4)
            mn[:, j] = (scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)
    return sc, mn


#: block-quantized tensors dequantized by each path in this process
DEQUANT_PATHS = {"native": 0, "numpy": 0}


def _dequant(raw: np.ndarray, ggml_type: int) -> np.ndarray:
    """Raw tensor bytes → float32 values: a block type through the native
    dequant where it is available (aha_tpu/io/gguf.py:240-249 takes the
    same order), else through numpy."""
    if ggml_type in _BLOCK and _BLOCK[ggml_type][0] > 1:
        from aha_tpu_torch import native

        out = native.dequant(_TYPE_NAMES.get(ggml_type, "").lower(), raw)
        DEQUANT_PATHS["native" if out is not None else "numpy"] += 1
        if out is not None:
            return out
    return _dequant_numpy(raw, ggml_type)


def _dequant_numpy(raw: np.ndarray, ggml_type: int) -> np.ndarray:
    if ggml_type == GGML_F32:
        return raw.view(np.float32)
    if ggml_type == GGML_F16:
        return raw.view(np.float16).astype(np.float32)
    if ggml_type == GGML_BF16:            # bf16 is the high half of an f32
        return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    if ggml_type == GGML_Q8_0:
        b = raw.reshape(-1, 34)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        q = b[:, 2:].view(np.int8).astype(np.float32)
        return (d * q).reshape(-1)
    if ggml_type == GGML_Q4_0:
        b = raw.reshape(-1, 18)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        qs = b[:, 2:]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        q = np.concatenate([lo, hi], axis=1).astype(np.float32)
        return (d * q).reshape(-1)
    if ggml_type == GGML_Q4_1:
        b = raw.reshape(-1, 20)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        m = _f16(b[:, 2:4].reshape(-1))[:, None]
        qs = b[:, 4:]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)
        return (d * q + m).reshape(-1)
    if ggml_type == GGML_Q5_0:
        b = raw.reshape(-1, 22)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        qh = b[:, 2:6].copy().view(np.uint32)[:, 0]
        qs = b[:, 6:]
        lo = (qs & 0x0F).astype(np.int32)
        hi = (qs >> 4).astype(np.int32)
        bits = ((qh[:, None] >> np.arange(32)[None, :]) & 1).astype(np.int32)
        q = np.concatenate([lo, hi], axis=1) | (bits << 4)
        return (d * (q - 16).astype(np.float32)).reshape(-1)
    if ggml_type == GGML_IQ4_NL:
        b = raw.reshape(-1, 18)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        qs = b[:, 2:]
        lo = IQ4_NL_KVALUES[(qs & 0x0F).astype(np.int64)]
        hi = IQ4_NL_KVALUES[(qs >> 4).astype(np.int64)]
        q = np.concatenate([lo, hi], axis=1)
        return (d * q).reshape(-1)
    if ggml_type == GGML_Q6_K:
        # block 256: ql[128] (low 4 bits), qh[64] (high 2 bits),
        # scales[16] (int8, per 16 elems), d (f16)
        b = raw.reshape(-1, 210)
        ql = b[:, :128]
        qh = b[:, 128:192]
        sc = b[:, 192:208].view(np.int8).astype(np.float32)
        d = _f16(b[:, 208:210].reshape(-1))[:, None]
        nb = b.shape[0]
        q = np.zeros((nb, 256), np.float32)
        for half in range(2):  # two 128-element halves
            lo = ql[:, half * 64:(half + 1) * 64]
            hi = qh[:, half * 32:(half + 1) * 32]
            # GGML layout per half (llama.cpp dequantize_row_q6_K): element
            # groups at +0/+32/+64/+96 draw low nibbles from
            # ql[0:32]&F, ql[32:64]&F, ql[0:32]>>4, ql[32:64]>>4 and high
            # 2-bit groups from qh>>0, >>2, >>4, >>6 respectively.
            parts = (lo[:, :32] & 0x0F, lo[:, 32:64] & 0x0F,
                     lo[:, :32] >> 4, lo[:, 32:64] >> 4)
            for i, qv in enumerate(parts):
                base = half * 128 + i * 32
                hbits = (hi >> (i * 2)) & 0x03
                q[:, base:base + 32] = (qv | (hbits << 4)).astype(np.int32) - 32
        scales = np.repeat(sc, 16, axis=1)
        return (d * scales * q).reshape(-1)
    if ggml_type == GGML_Q4_K:
        # block 256: d (f16), dmin (f16), scales[12], qs[128]
        b = raw.reshape(-1, 144)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        dmin = _f16(b[:, 2:4].reshape(-1))[:, None]
        qs = b[:, 16:]
        nb = b.shape[0]
        sc, mn = _unpack_k4_scales(b[:, 4:16])
        q = np.zeros((nb, 256), np.float32)
        for j in range(4):  # four 64-element groups from 32 bytes each
            blk = qs[:, j * 32:(j + 1) * 32]
            lo = (blk & 0x0F).astype(np.float32)
            hi = (blk >> 4).astype(np.float32)
            q[:, j * 64:j * 64 + 32] = d * sc[:, 2 * j:2 * j + 1] * lo \
                - dmin * mn[:, 2 * j:2 * j + 1]
            q[:, j * 64 + 32:j * 64 + 64] = d * sc[:, 2 * j + 1:2 * j + 2] * hi \
                - dmin * mn[:, 2 * j + 1:2 * j + 2]
        return q.reshape(-1)
    if ggml_type == GGML_Q5_K:
        # block 256: d (f16), dmin (f16), scales[12] (same 6-bit packing as
        # Q4_K), qh[32] (5th bits), qs[128] (nibbles); dequantize_row_q5_K
        b = raw.reshape(-1, 176)
        d = _f16(b[:, :2].reshape(-1))[:, None]
        dmin = _f16(b[:, 2:4].reshape(-1))[:, None]
        sc, mn = _unpack_k4_scales(b[:, 4:16])
        qh = b[:, 16:48]
        qs = b[:, 48:]
        nb = b.shape[0]
        q = np.zeros((nb, 256), np.float32)
        for j in range(4):           # four 64-elem groups from 32 ql bytes
            blk = qs[:, j * 32:(j + 1) * 32]
            u1, u2 = 1 << (2 * j), 1 << (2 * j + 1)
            lo = (blk & 0x0F) + np.where(qh & u1, 16, 0)
            hi = (blk >> 4) + np.where(qh & u2, 16, 0)
            q[:, j * 64:j * 64 + 32] = (d * sc[:, 2 * j:2 * j + 1]
                                        * lo.astype(np.float32)
                                        - dmin * mn[:, 2 * j:2 * j + 1])
            q[:, j * 64 + 32:j * 64 + 64] = (d * sc[:, 2 * j + 1:2 * j + 2]
                                             * hi.astype(np.float32)
                                             - dmin * mn[:, 2 * j + 1:2 * j + 2])
        return q.reshape(-1)
    if ggml_type == GGML_Q2_K:
        # block 256: scales[16] (lo nibble scale, hi nibble min), qs[64]
        # (2-bit planes), d (f16), dmin (f16); dequantize_row_q2_K
        b = raw.reshape(-1, 84)
        scales = b[:, :16]
        qs = b[:, 16:80]
        d = _f16(b[:, 80:82].reshape(-1))[:, None]
        dmin = _f16(b[:, 82:84].reshape(-1))[:, None]
        nb = b.shape[0]
        q = np.zeros((nb, 256), np.float32)
        for half in range(2):        # 128 elems from 32 qs bytes each
            blk = qs[:, half * 32:(half + 1) * 32]
            for j in range(4):       # 2-bit planes, shift 0/2/4/6
                two = (blk >> (2 * j)) & 3
                for sub in range(2):  # two 16-elem subgroups per plane
                    s_idx = half * 8 + j * 2 + sub
                    sc = scales[:, s_idx:s_idx + 1]
                    dl = d * (sc & 0x0F).astype(np.float32)
                    ml = dmin * (sc >> 4).astype(np.float32)
                    base = half * 128 + j * 32 + sub * 16
                    q[:, base:base + 16] = \
                        dl * two[:, sub * 16:(sub + 1) * 16] - ml
        return q.reshape(-1)
    if ggml_type == GGML_Q3_K:
        # block 256: hmask[32] (high bit, inverted offset), qs[64] (2-bit
        # planes), scales[12] (16 packed 6-bit, bias 32), d (f16);
        # dequantize_row_q3_K
        b = raw.reshape(-1, 110)
        hmask = b[:, :32]
        qs = b[:, 32:96]
        packed = b[:, 96:108].copy().view(np.uint32)  # (nb, 3) LE words
        d = _f16(b[:, 108:110].reshape(-1))[:, None]
        km1, km2 = 0x03030303, 0x0F0F0F0F
        a0 = (packed[:, 0] & km2) | (((packed[:, 2] >> 0) & km1) << 4)
        a1 = (packed[:, 1] & km2) | (((packed[:, 2] >> 2) & km1) << 4)
        a2 = ((packed[:, 0] >> 4) & km2) | (((packed[:, 2] >> 4) & km1) << 4)
        a3 = ((packed[:, 1] >> 4) & km2) | (((packed[:, 2] >> 6) & km1) << 4)
        scales = np.stack([a0, a1, a2, a3], axis=1).view(np.int8)  # (nb, 16)
        scales = scales.astype(np.float32) - 32.0
        nb = b.shape[0]
        q = np.zeros((nb, 256), np.float32)
        for half in range(2):
            blk = qs[:, half * 32:(half + 1) * 32]
            for j in range(4):
                two = ((blk >> (2 * j)) & 3).astype(np.int8)
                m = 1 << (half * 4 + j)
                hbit = np.where(hmask & m, 0, 4).astype(np.int8)
                val = (two - hbit).astype(np.float32)
                for sub in range(2):
                    s_idx = half * 8 + j * 2 + sub
                    dl = d * scales[:, s_idx:s_idx + 1]
                    base = half * 128 + j * 32 + sub * 16
                    q[:, base:base + 16] = \
                        dl * val[:, sub * 16:(sub + 1) * 16]
        return q.reshape(-1)
    raise NotImplementedError(
        f"gguf dequant for type {_TYPE_NAMES.get(ggml_type, ggml_type)}")


# ---------------------------------------------------------------------------
# Writer (tests + tooling): minimal GGUF v3 emitter
# ---------------------------------------------------------------------------


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    d = np.abs(x).max(axis=1) / 127.0
    d_safe = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(x / d_safe[:, None]), -127, 127).astype(np.int8)
    out = np.zeros((x.shape[0], 34), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax_idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -8.0
    d_safe = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(x / d_safe[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.zeros((x.shape[0], 18), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_iq4_nl(x: np.ndarray) -> np.ndarray:
    """Nearest-kvalue IQ4_NL packing (simplified scale search)."""
    x = x.reshape(-1, 32).astype(np.float32)
    amax_idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / IQ4_NL_KVALUES[0]  # scale so the max maps near the extreme
    d_safe = np.where(d == 0, 1.0, d)
    scaled = x / d_safe[:, None]
    idx = np.abs(scaled[..., None] - IQ4_NL_KVALUES[None, None, :]).argmin(-1)
    idx = idx.astype(np.uint8)
    out = np.zeros((x.shape[0], 18), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = idx[:, :16] | (idx[:, 16:] << 4)
    return out.reshape(-1)


def _pack_k4_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """(nb, 8) six-bit scales + mins → (nb, 12) bytes (inverse of
    _unpack_k4_scales)."""
    nb = sc.shape[0]
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        out[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)
    return out


def _asym_group_quant(x: np.ndarray, n_groups: int, qmax: int, smax: int):
    """Per-group asymmetric quantization v ≈ d·sc·q − dmin·mn.

    x: (nb, 256) → (d (nb,1), dmin (nb,1), sc (nb,G), mn (nb,G),
    q (nb, 256) ∈ [0, qmax])."""
    nb = x.shape[0]
    g = x.reshape(nb, n_groups, -1)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = np.maximum(g.max(axis=2), 0.0)
    s_g = (gmax - gmin) / qmax                       # per-group scale
    o_g = -gmin                                      # per-group offset
    d = s_g.max(axis=1, keepdims=True) / smax
    dmin = o_g.max(axis=1, keepdims=True) / smax
    d_safe = np.where(d == 0, 1.0, d)
    dmin_safe = np.where(dmin == 0, 1.0, dmin)
    sc = np.clip(np.round(s_g / d_safe), 0, smax)
    mn = np.clip(np.round(o_g / dmin_safe), 0, smax)
    eff = d * sc
    eff_safe = np.where(eff == 0, 1.0, eff)
    q = np.round((g + (dmin * mn)[..., None]) / eff_safe[..., None])
    q = np.clip(q, 0, qmax).astype(np.uint8).reshape(nb, -1)
    return d, dmin, sc, mn, q


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 256).astype(np.float32)
    d, dmin, sc, mn, q = _asym_group_quant(x, 8, 15, 63)
    nb = x.shape[0]
    out = np.zeros((nb, 144), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8)
    out[:, 4:16] = _pack_k4_scales(sc, mn)
    for j in range(4):
        lo = q[:, j * 64:j * 64 + 32]
        hi = q[:, j * 64 + 32:j * 64 + 64]
        out[:, 16 + j * 32:16 + (j + 1) * 32] = lo | (hi << 4)
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 256).astype(np.float32)
    d, dmin, sc, mn, q = _asym_group_quant(x, 8, 31, 63)
    # widen to 5 bits: requantize with qmax 31 kept (exact 5-bit range)
    nb = x.shape[0]
    out = np.zeros((nb, 176), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8)
    out[:, 4:16] = _pack_k4_scales(sc, mn)
    qh = np.zeros((nb, 32), np.uint8)
    for j in range(4):
        lo5 = q[:, j * 64:j * 64 + 32]
        hi5 = q[:, j * 64 + 32:j * 64 + 64]
        out[:, 48 + j * 32:48 + (j + 1) * 32] = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4)
        qh |= ((lo5 >> 4) << (2 * j)) | ((hi5 >> 4) << (2 * j + 1))
    out[:, 16:48] = qh
    return out.reshape(-1)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 256).astype(np.float32)
    d, dmin, sc, mn, q = _asym_group_quant(x, 16, 3, 15)
    nb = x.shape[0]
    out = np.zeros((nb, 84), np.uint8)
    out[:, :16] = (sc.astype(np.uint8) & 0x0F) | (mn.astype(np.uint8) << 4)
    qs = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        for j in range(4):
            plane = q[:, half * 128 + j * 32:half * 128 + (j + 1) * 32]
            qs[:, half * 32:(half + 1) * 32] |= (plane & 3) << (2 * j)
    out[:, 16:80] = qs
    out[:, 80:82] = d.astype(np.float16).view(np.uint8)
    out[:, 82:84] = dmin.astype(np.float16).view(np.uint8)
    return out.reshape(-1)


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 256).astype(np.float32)
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)
    s_g = amax / 4.0                                  # q in [-4, 3]
    d = s_g.max(axis=1, keepdims=True) / 31.0         # |scale-32| ≤ 31
    d_safe = np.where(d == 0, 1.0, d)
    sc = np.clip(np.round(s_g / d_safe), -32, 31)
    eff = d * sc
    eff_safe = np.where(eff == 0, 1.0, eff)
    q = np.clip(np.round(g / eff_safe[..., None]), -4, 3).astype(np.int8)
    q = q.reshape(nb, 256)
    out = np.zeros((nb, 110), np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        for j in range(4):
            plane = q[:, half * 128 + j * 32:half * 128 + (j + 1) * 32]
            m = 1 << (half * 4 + j)
            # val = two − (hbit ? 0 : 4): q≥0 → two=q, bit set;
            # q<0 → two=q+4, bit clear
            neg = plane < 0
            two = np.where(neg, plane + 4, plane).astype(np.uint8)
            hmask[:, :] |= np.where(neg, 0, m).astype(np.uint8)
            qs[:, half * 32:(half + 1) * 32] |= (two & 3) << (2 * j)
    out[:, :32] = hmask
    out[:, 32:96] = qs
    s16 = (sc + 32).astype(np.uint8)                  # 16 six-bit values
    packed = np.zeros((nb, 12), np.uint8)
    for k in range(4):
        packed[:, k] = (s16[:, k] & 0x0F) | ((s16[:, 8 + k] & 0x0F) << 4)
        packed[:, 4 + k] = (s16[:, 4 + k] & 0x0F) | ((s16[:, 12 + k] & 0x0F) << 4)
        packed[:, 8 + k] = (((s16[:, k] >> 4) & 0x3)
                            | (((s16[:, 4 + k] >> 4) & 0x3) << 2)
                            | (((s16[:, 8 + k] >> 4) & 0x3) << 4)
                            | (((s16[:, 12 + k] >> 4) & 0x3) << 6))
    out[:, 96:108] = packed
    out[:, 108:110] = d.astype(np.float16).view(np.uint8)
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 256).astype(np.float32)
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)
    s_g = amax / 31.0                                 # q-32 in [-32, 31]
    d = s_g.max(axis=1, keepdims=True) / 127.0
    d_safe = np.where(d == 0, 1.0, d)
    sc = np.clip(np.round(s_g / d_safe), -128, 127)
    eff = d * sc
    eff_safe = np.where(eff == 0, 1.0, eff)
    q = np.clip(np.round(g / eff_safe[..., None]), -32, 31) + 32
    q = q.astype(np.uint8).reshape(nb, 256)
    out = np.zeros((nb, 210), np.uint8)
    for half in range(2):
        base = half * 128
        grp = [q[:, base + i * 32:base + (i + 1) * 32] for i in range(4)]
        # low nibbles: groups 0/2 → ql[0:32], groups 1/3 → ql[32:64]
        out[:, half * 64:half * 64 + 32] = (grp[0] & 0x0F) | ((grp[2] & 0x0F) << 4)
        out[:, half * 64 + 32:half * 64 + 64] = (grp[1] & 0x0F) | ((grp[3] & 0x0F) << 4)
        qh = np.zeros((nb, 32), np.uint8)
        for i in range(4):
            qh |= (grp[i] >> 4) << (2 * i)
        out[:, 128 + half * 32:128 + (half + 1) * 32] = qh
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = d.astype(np.float16).view(np.uint8)
    return out.reshape(-1)


def write_gguf(path: str, metadata: dict, tensors: dict[str, tuple[np.ndarray, int]],
               alignment: int = 32) -> None:
    """tensors: name → (array, ggml_type). Arrays are raw float data;
    quantized types are packed here, a thread a host core (numpy releases
    the GIL in the quantizers' array operations). Test/tooling emitter."""
    def pack_str(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def pack_value(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", _V_BOOL) + struct.pack("<?", v)
        if isinstance(v, int):
            return struct.pack("<I", _V_U32) + struct.pack("<I", v)
        if isinstance(v, float):
            return struct.pack("<I", _V_F32) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", _V_STR) + pack_str(v)
        if isinstance(v, list):
            if all(isinstance(x, str) for x in v):
                body = b"".join(pack_str(x) for x in v)
                return (struct.pack("<I", _V_ARR) + struct.pack("<I", _V_STR)
                        + struct.pack("<Q", len(v)) + body)
            body = b"".join(struct.pack("<i", int(x)) for x in v)
            return (struct.pack("<I", _V_ARR) + struct.pack("<I", _V_I32)
                    + struct.pack("<Q", len(v)) + body)
        raise TypeError(type(v))

    packers = {GGML_F32: lambda a: a.astype(np.float32),
               GGML_F16: lambda a: a.astype(np.float16),
               GGML_Q8_0: quantize_q8_0, GGML_Q4_0: quantize_q4_0,
               GGML_IQ4_NL: quantize_iq4_nl, GGML_Q4_K: quantize_q4_k,
               GGML_Q5_K: quantize_q5_k, GGML_Q6_K: quantize_q6_k,
               GGML_Q2_K: quantize_q2_k, GGML_Q3_K: quantize_q3_k}

    def pack(item):
        arr, gt = item
        if gt not in packers:
            raise NotImplementedError(f"writer for type {gt}")
        return packers[gt](arr).tobytes()

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        payloads = dict(zip(tensors, pool.map(pack, tensors.values())))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGUF_MAGIC))
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", len(tensors)))
        f.write(struct.pack("<Q", len(metadata)))
        for k, v in metadata.items():
            f.write(pack_str(k))
            f.write(pack_value(v))
        offset = 0
        for name, (arr, gt) in tensors.items():
            f.write(pack_str(name))
            dims = list(reversed(arr.shape))
            f.write(struct.pack("<I", len(dims)))
            for dim in dims:
                f.write(struct.pack("<Q", dim))
            f.write(struct.pack("<I", gt))
            f.write(struct.pack("<Q", offset))
            n = len(payloads[name])
            offset += (n + alignment - 1) // alignment * alignment
        pos = f.tell()
        f.write(b"\x00" * ((-pos) % alignment))
        for name in tensors:
            data = payloads[name]
            f.write(data)
            f.write(b"\x00" * ((-len(data)) % alignment))
