/* TIFF-flavour LZW decoder (native hot path for the pyramidal WSI reader).
 *
 * The reference decodes WSI tiles through libtiff inside OpenSlide (C);
 * our pure-Python reader (mhim_mil_torch/preprocess/tiff.py:_lzw_decode) is
 * correct but ~two orders of magnitude slower on the byte loop, which makes
 * it the L0 bottleneck for LZW-compressed slides (CAMELYON16 .tif is LZW).
 * This file is the C equivalent: MSB-first variable-width codes (9..12
 * bits), CLEAR=256 / EOI=257, and the TIFF "early change" convention where
 * the code width bumps one entry early.
 *
 * Decode uses the classic prefix-chain table: each entry stores
 * (prefix_code, suffix_byte, length); a code is emitted by walking the
 * chain backwards into a stack buffer.  No heap allocation per call.
 *
 * ABI (loaded via ctypes from mhim_mil_torch/native/__init__.py):
 *   long tiff_lzw_decode(const unsigned char* src, long nsrc,
 *                        unsigned char* dst, long cap);
 * Returns bytes written (stops early when dst is full — callers size dst
 * to the tile geometry and trailing pad is irrelevant), or -1 on a
 * malformed stream.
 */

#include <stdint.h>
#include <string.h>

#define LZW_CLEAR 256
#define LZW_EOI 257
#define LZW_FIRST 258
#define LZW_MAX_CODES 4096

long tiff_lzw_decode(const unsigned char *src, long nsrc,
                     unsigned char *dst, long cap) {
    /* prefix chain; lengths let us bounds-check the walk buffer */
    static _Thread_local uint16_t prefix[LZW_MAX_CODES];
    static _Thread_local unsigned char suffix[LZW_MAX_CODES];
    static _Thread_local unsigned char first[LZW_MAX_CODES];
    static _Thread_local uint16_t length[LZW_MAX_CODES];
    unsigned char stack[LZW_MAX_CODES];

    long si = 0, di = 0;
    uint32_t buf = 0;
    int nbits = 0, width = 9;
    int next_code = LZW_FIRST;
    int prev = -1;

    for (int i = 0; i < 256; i++) {
        prefix[i] = 0xFFFF;
        suffix[i] = (unsigned char)i;
        first[i] = (unsigned char)i;
        length[i] = 1;
    }

    while (di < cap) {
        while (nbits < width) {
            if (si >= nsrc) return di; /* stream exhausted without EOI */
            buf = (buf << 8) | src[si++];
            nbits += 8;
        }
        int code = (int)((buf >> (nbits - width)) & ((1u << width) - 1));
        nbits -= width;

        if (code == LZW_CLEAR) {
            next_code = LZW_FIRST;
            width = 9;
            prev = -1;
            continue;
        }
        if (code == LZW_EOI) return di;

        int emit;
        if (prev < 0) {
            if (code >= 256) return -1; /* first code must be a literal */
            emit = code;
        } else if (code < next_code) {
            emit = code;
            if (next_code < LZW_MAX_CODES) {
                prefix[next_code] = (uint16_t)prev;
                suffix[next_code] = first[code];
                first[next_code] = first[prev];
                length[next_code] = (uint16_t)(length[prev] + 1);
                next_code++;
            }
        } else if (code == next_code && next_code < LZW_MAX_CODES) {
            /* KwKwK case: new entry = prev + first(prev) */
            prefix[next_code] = (uint16_t)prev;
            suffix[next_code] = first[prev];
            first[next_code] = first[prev];
            length[next_code] = (uint16_t)(length[prev] + 1);
            next_code++;
            emit = code;
        } else {
            return -1; /* code beyond table: malformed */
        }

        /* walk the chain backwards into the stack, then copy forward */
        int n = length[emit];
        if (n > (int)sizeof(stack)) return -1;
        int c = emit;
        for (int k = n - 1; k >= 0; k--) {
            stack[k] = suffix[c];
            c = (prefix[c] == 0xFFFF) ? -1 : prefix[c];
        }
        long take = (di + n <= cap) ? n : cap - di;
        memcpy(dst + di, stack, (size_t)take);
        di += take;

        prev = emit;
        /* TIFF early change: bump width one code early (matches the
         * pure-Python reference decoder in preprocess/tiff.py) */
        if (next_code + 1 >= (1 << width) && width < 12) width++;
    }
    return di;
}

/* PackBits (TIFF compression 32773): trivial RLE, included so the native
 * path covers every non-PIL codec the reader supports. */
long tiff_packbits_decode(const unsigned char *src, long nsrc,
                          unsigned char *dst, long cap) {
    long si = 0, di = 0;
    while (si < nsrc && di < cap) {
        signed char n = (signed char)src[si++];
        if (n >= 0) {
            long cnt = (long)n + 1;
            if (si + cnt > nsrc) cnt = nsrc - si;
            if (di + cnt > cap) cnt = cap - di;
            memcpy(dst + di, src + si, (size_t)cnt);
            si += cnt;
            di += cnt;
        } else if (n != -128) {
            long cnt = 1 - (long)n;
            if (si >= nsrc) break;
            if (di + cnt > cap) cnt = cap - di;
            memset(dst + di, src[si++], (size_t)cnt);
            di += cnt;
        }
    }
    return di;
}
