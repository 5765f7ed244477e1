// Baseline scan sizes from packed symbol counts: the host half of the
// device rate accounting (kernels/jpeg_rate.py).
//
// Each row of `packed` holds one scan's [dc_y 16 | dc_c 16 | ac_y 256 |
// ac_c 256] symbol counts.  The four tables are built by the optimal
// length-limited Huffman construction of ITU T.81 Annex K.2 (Figures
// K.1-K.3), the construction native/jpeg_entropy.cpp's coder uses, and
// the row gets its scan's entropy-coded bits (codes plus appended bits: s
// for DC category s, sym & 15 for AC symbol sym; no flush padding, no
// 0xFF stuffing) and the symbol count of its four DHT segments.
//
// Only code lengths are needed here, so canonical codes are not assigned.
// Built by codec_eval_tpu_torch/utils/native.py into the port's host
// library, beside native/*.cpp.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// Code length of each of the 256 symbols (0 for an absent one) and the
// number of symbols coded.
int code_sizes(const uint32_t* freq_in, int* size) {
    uint32_t freq[257];
    int codesize[257];
    int others[257];
    std::memcpy(freq, freq_in, 256 * sizeof(uint32_t));
    freq[256] = 1;  // the reserved symbol: no real symbol gets all ones
    for (int i = 0; i < 257; ++i) { codesize[i] = 0; others[i] = -1; }

    // Figure K.1: merge the two least frequent trees (the higher symbol
    // of equal frequencies first).
    for (;;) {
        int c1 = -1, c2 = -1;
        uint32_t v = 0xFFFFFFFFu;
        for (int i = 0; i <= 256; ++i)
            if (freq[i] && freq[i] <= v) { v = freq[i]; c1 = i; }
        v = 0xFFFFFFFFu;
        for (int i = 0; i <= 256; ++i)
            if (freq[i] && freq[i] <= v && i != c1) { v = freq[i]; c2 = i; }
        if (c2 < 0) break;
        freq[c1] += freq[c2];
        freq[c2] = 0;
        for (codesize[c1]++; others[c1] >= 0; codesize[c1]++) c1 = others[c1];
        others[c1] = c2;
        for (codesize[c2]++; others[c2] >= 0; codesize[c2]++) c2 = others[c2];
    }

    // Figure K.2: codes per length; K.3: fold lengths over 16 down.
    int bits[33];
    std::memset(bits, 0, sizeof(bits));
    for (int i = 0; i <= 256; ++i)
        if (codesize[i]) bits[codesize[i] > 32 ? 32 : codesize[i]]++;
    for (int i = 32; i > 16; --i) {
        while (bits[i] > 0) {
            int j = i - 2;
            while (bits[j] == 0) --j;
            bits[i] -= 2;
            bits[i - 1] += 1;
            bits[j + 1] += 2;
            bits[j] -= 1;
        }
    }
    int top = 16;
    while (top > 0 && bits[top] == 0) --top;
    if (top > 0) bits[top]--;  // drop the reserved symbol's code

    // Lengths go to the symbols in (unfolded length, symbol) order, as the
    // coder's canonical assignment gives them.
    std::memset(size, 0, 256 * sizeof(int));
    int n = 0, l = 1;
    for (int cs = 1; cs <= 32; ++cs)
        for (int s = 0; s < 256; ++s)
            if (codesize[s] == cs) {
                while (l <= 16 && bits[l] == 0) ++l;
                if (l <= 16) { size[s] = l; bits[l]--; }
                ++n;
            }
    return n;
}

}  // namespace

extern "C" {

// Returns 0, or -1 on a null pointer, a negative count, or a table whose
// counts (with the reserved symbol) exceed 32-bit frequencies.
int64_t ce_jpeg_baseline_scan_bits(const int64_t* packed, size_t rows,
                                   int64_t* bits_out, int64_t* nsyms_out) {
    if (!packed || !bits_out || !nsyms_out) return -1;
    static const int kOffset[4] = {0, 16, 32, 288};
    static const int kWidth[4] = {16, 16, 256, 256};
    for (size_t r = 0; r < rows; ++r) {
        const int64_t* row = packed + r * 544;
        int64_t bits = 0, nsyms = 0;
        for (int t = 0; t < 4; ++t) {
            uint32_t freq[256];
            std::memset(freq, 0, sizeof(freq));
            int64_t total = 1;
            for (int s = 0; s < kWidth[t]; ++s) {
                int64_t f = row[kOffset[t] + s];
                if (f < 0) return -1;
                total += f;
                if (total > int64_t(0xFFFFFFFFu)) return -1;
                freq[s] = uint32_t(f);
            }
            int size[256];
            nsyms += code_sizes(freq, size);
            for (int s = 0; s < kWidth[t]; ++s)
                if (freq[s])
                    bits += int64_t(freq[s]) * (size[s] + (t < 2 ? s : (s & 15)));
        }
        bits_out[r] = bits;
        nsyms_out[r] = nsyms;
    }
    return 0;
}

}  // extern "C"
