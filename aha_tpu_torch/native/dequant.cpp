// GGUF block dequantization, the native host path of aha_tpu_torch (a copy
// of aha_tpu/native/dequant.cpp: the port imports nothing of aha_tpu).
//
// The numpy dequant in aha_tpu_torch/io/gguf.py is the behavioural
// reference but runs at ~9 Melem/s on K-quants, which puts seconds of host
// work into every quantized-model load (embeddings, norms and dense heads
// are dequantized on the host; matmul weights are repacked onto the port's
// grids).  This file compiles to a plain C-ABI shared library (built at
// first use by aha_tpu_torch/native/__init__.py with g++ -O3 -shared -fPIC
// -fopenmp into the port's build directory) and is loaded with ctypes.
//
// Layouts follow ggml (llama.cpp) exactly; tests/test_torch_native_dequant.py
// holds native == numpy within f32 rounding for every block type.

#include <cstdint>
#include <cstring>

static inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {                     // subnormal
            exp = 127 - 15 + 1;
            while (!(man & 0x400)) { man <<= 1; exp--; }
            man &= 0x3FF;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static inline uint16_t rd16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

extern "C" {

// q8_0: 34-byte block = f16 d + 32 × int8
void dequant_q8_0(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 34;
        float d = f16_to_f32(rd16(p));
        const int8_t* q = (const int8_t*)(p + 2);
        float* o = out + b * 32;
        for (int i = 0; i < 32; i++) o[i] = d * (float)q[i];
    }
}

// q4_0: 18-byte block = f16 d + 16 bytes of nibbles (lo 16 elems, hi 16)
void dequant_q4_0(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 18;
        float d = f16_to_f32(rd16(p));
        const uint8_t* qs = p + 2;
        float* o = out + b * 32;
        for (int i = 0; i < 16; i++) {
            o[i]      = d * (float)((int)(qs[i] & 0x0F) - 8);
            o[i + 16] = d * (float)((int)(qs[i] >> 4) - 8);
        }
    }
}

// q4_1: 20-byte block = f16 d + f16 m + 16 bytes of nibbles
void dequant_q4_1(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 20;
        float d = f16_to_f32(rd16(p));
        float m = f16_to_f32(rd16(p + 2));
        const uint8_t* qs = p + 4;
        float* o = out + b * 32;
        for (int i = 0; i < 16; i++) {
            o[i]      = d * (float)(qs[i] & 0x0F) + m;
            o[i + 16] = d * (float)(qs[i] >> 4) + m;
        }
    }
}

// q5_0: 22-byte block = f16 d + u32 qh + 16 bytes of nibbles
void dequant_q5_0(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 22;
        float d = f16_to_f32(rd16(p));
        uint32_t qh;
        std::memcpy(&qh, p + 2, 4);
        const uint8_t* qs = p + 6;
        float* o = out + b * 32;
        for (int i = 0; i < 16; i++) {
            int lo = (qs[i] & 0x0F) | (((qh >> i) & 1) << 4);
            int hi = (qs[i] >> 4) | (((qh >> (i + 16)) & 1) << 4);
            o[i]      = d * (float)(lo - 16);
            o[i + 16] = d * (float)(hi - 16);
        }
    }
}

// iq4_nl: 18-byte block = f16 d + 16 bytes of nibble indices into kvalues
static const int8_t IQ4_NL_KV[16] = {-127, -104, -83, -65, -49, -35, -22,
                                     -10, 1, 13, 25, 38, 53, 69, 89, 113};
void dequant_iq4_nl(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 18;
        float d = f16_to_f32(rd16(p));
        const uint8_t* qs = p + 2;
        float* o = out + b * 32;
        for (int i = 0; i < 16; i++) {
            o[i]      = d * (float)IQ4_NL_KV[qs[i] & 0x0F];
            o[i + 16] = d * (float)IQ4_NL_KV[qs[i] >> 4];
        }
    }
}

// q4_k: 144-byte block of 256 = f16 d, f16 dmin, 12-byte packed 6-bit
// scales/mins (8 each), 128 bytes of nibbles in four 32-byte groups
void dequant_q4_k(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 144;
        float d = f16_to_f32(rd16(p));
        float dmin = f16_to_f32(rd16(p + 2));
        const uint8_t* scales = p + 4;
        const uint8_t* qs = p + 16;
        float sc[8], mn[8];
        for (int j = 0; j < 8; j++) {
            if (j < 4) {
                sc[j] = (float)(scales[j] & 63);
                mn[j] = (float)(scales[j + 4] & 63);
            } else {
                sc[j] = (float)((scales[j + 4] & 0x0F) |
                                ((scales[j - 4] >> 6) << 4));
                mn[j] = (float)((scales[j + 4] >> 4) |
                                ((scales[j] >> 6) << 4));
            }
        }
        float* o = out + b * 256;
        for (int j = 0; j < 4; j++) {
            const uint8_t* blk = qs + j * 32;
            float dl = d * sc[2 * j], ml = dmin * mn[2 * j];
            float dh = d * sc[2 * j + 1], mh = dmin * mn[2 * j + 1];
            float* ol = o + j * 64;
            for (int i = 0; i < 32; i++) {
                ol[i]      = dl * (float)(blk[i] & 0x0F) - ml;
                ol[i + 32] = dh * (float)(blk[i] >> 4) - mh;
            }
        }
    }
}

// q6_k: 210-byte block of 256 = ql[128] + qh[64] + int8 scales[16] + f16 d
void dequant_q6_k(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 210;
        const uint8_t* ql = p;
        const uint8_t* qh = p + 128;
        const int8_t* sc = (const int8_t*)(p + 192);
        float d = f16_to_f32(rd16(p + 208));
        float* o = out + b * 256;
        for (int half = 0; half < 2; half++) {
            const uint8_t* lo = ql + half * 64;
            const uint8_t* hi = qh + half * 32;
            for (int grp = 0; grp < 4; grp++) {
                // groups at +0/+32/+64/+96: low nibbles from lo[0:32]&F,
                // lo[32:64]&F, lo[0:32]>>4, lo[32:64]>>4; high 2 bits from
                // hi >> (2*grp)  (dequantize_row_q6_K)
                const uint8_t* lsrc = lo + (grp & 1) * 32;
                int shift = (grp & 2) ? 4 : 0;
                float* og = o + half * 128 + grp * 32;
                float s = d * (float)sc[half * 8 + grp * 2];
                float s1 = d * (float)sc[half * 8 + grp * 2 + 1];
                for (int i = 0; i < 32; i++) {
                    int q = ((lsrc[i] >> shift) & 0x0F) |
                            (((hi[i] >> (grp * 2)) & 0x03) << 4);
                    float scale = (i < 16) ? s : s1;
                    og[i] = scale * (float)(q - 32);
                }
            }
        }
    }
}

// q5_k: 176-byte block of 256 = f16 d, f16 dmin, 12-byte 6-bit scales
// (same packing as q4_k), qh[32] fifth bits, qs[128] nibbles
void dequant_q5_k(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 176;
        float d = f16_to_f32(rd16(p));
        float dmin = f16_to_f32(rd16(p + 2));
        const uint8_t* scales = p + 4;
        const uint8_t* qh = p + 16;
        const uint8_t* qs = p + 48;
        float sc[8], mn[8];
        for (int j = 0; j < 8; j++) {
            if (j < 4) {
                sc[j] = (float)(scales[j] & 63);
                mn[j] = (float)(scales[j + 4] & 63);
            } else {
                sc[j] = (float)((scales[j + 4] & 0x0F) |
                                ((scales[j - 4] >> 6) << 4));
                mn[j] = (float)((scales[j + 4] >> 4) |
                                ((scales[j] >> 6) << 4));
            }
        }
        float* o = out + b * 256;
        for (int j = 0; j < 4; j++) {
            const uint8_t* blk = qs + j * 32;
            uint8_t u1 = 1 << (2 * j), u2 = 1 << (2 * j + 1);
            float dl = d * sc[2 * j], ml = dmin * mn[2 * j];
            float dh = d * sc[2 * j + 1], mh = dmin * mn[2 * j + 1];
            float* og = o + j * 64;
            for (int i = 0; i < 32; i++) {
                int lo = (blk[i] & 0x0F) + ((qh[i] & u1) ? 16 : 0);
                int hi = (blk[i] >> 4) + ((qh[i] & u2) ? 16 : 0);
                og[i]      = dl * (float)lo - ml;
                og[i + 32] = dh * (float)hi - mh;
            }
        }
    }
}

// q2_k: 84-byte block of 256 = scales[16] (lo nibble scale, hi nibble min),
// qs[64] 2-bit planes, f16 d, f16 dmin
void dequant_q2_k(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 84;
        const uint8_t* scales = p;
        const uint8_t* qs = p + 16;
        float d = f16_to_f32(rd16(p + 80));
        float dmin = f16_to_f32(rd16(p + 82));
        float* o = out + b * 256;
        for (int half = 0; half < 2; half++) {
            const uint8_t* blk = qs + half * 32;
            for (int j = 0; j < 4; j++) {
                for (int sub = 0; sub < 2; sub++) {
                    uint8_t s = scales[half * 8 + j * 2 + sub];
                    float dl = d * (float)(s & 0x0F);
                    float ml = dmin * (float)(s >> 4);
                    float* og = o + half * 128 + j * 32 + sub * 16;
                    for (int l = 0; l < 16; l++) {
                        int two = (blk[sub * 16 + l] >> (2 * j)) & 3;
                        og[l] = dl * (float)two - ml;
                    }
                }
            }
        }
    }
}

// q3_k: 110-byte block of 256 = hmask[32], qs[64] 2-bit planes, 12-byte
// packed 16×6-bit scales (bias 32), f16 d
void dequant_q3_k(const uint8_t* raw, int64_t n_blocks, float* out) {
#pragma omp parallel for
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* p = raw + b * 110;
        const uint8_t* hm = p;
        const uint8_t* qs = p + 32;
        const uint8_t* sb = p + 96;
        float d = f16_to_f32(rd16(p + 108));
        int8_t scales[16];
        for (int k = 0; k < 4; k++) {
            // inverse of the kmask shuffle (dequantize_row_q3_K)
            scales[k]      = (int8_t)((sb[k] & 0x0F) | (((sb[8 + k] >> 0) & 3) << 4));
            scales[4 + k]  = (int8_t)((sb[4 + k] & 0x0F) | (((sb[8 + k] >> 2) & 3) << 4));
            scales[8 + k]  = (int8_t)((sb[k] >> 4) | (((sb[8 + k] >> 4) & 3) << 4));
            scales[12 + k] = (int8_t)((sb[4 + k] >> 4) | (((sb[8 + k] >> 6) & 3) << 4));
        }
        float* o = out + b * 256;
        for (int half = 0; half < 2; half++) {
            const uint8_t* blk = qs + half * 32;
            for (int j = 0; j < 4; j++) {
                uint8_t m = 1 << (half * 4 + j);
                for (int sub = 0; sub < 2; sub++) {
                    float dl = d * (float)(scales[half * 8 + j * 2 + sub] - 32);
                    float* og = o + half * 128 + j * 32 + sub * 16;
                    for (int l = 0; l < 16; l++) {
                        int idx = sub * 16 + l;
                        int two = (blk[idx] >> (2 * j)) & 3;
                        int v = two - ((hm[idx] & m) ? 0 : 4);
                        og[l] = dl * (float)v;
                    }
                }
            }
        }
    }
}

}  // extern "C"
