// Native RLE mask ops for s2d_tpu_torch (C ABI, loaded via ctypes): the
// port's copy of s2d_tpu/native/rle_ops.cpp, unchanged in its functions.
//
// Host-side hot path of evaluation: COCO RLE encode/decode and pairwise
// track-IoU (results.json writing + spatio-temporal AP). These functions
// operate directly on run-length data: intersections are computed by
// merging run lists without ever materializing bitmaps.
//
// Also the PNG codec's scanline unfilter (data/png.py), whose Average and
// Paeth filters are a sequential walk along each row.
//
// Build: g++ -O3 -shared -fPIC at first use, into build/s2d_tpu_torch/
// (s2d_tpu_torch/native/__init__.py, which also holds the ctypes bindings);
// without g++ the callers take their numpy paths.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a column-major uint8 mask (h*w bytes, Fortran-flattened by the
// caller) into run counts. Returns the number of counts written (<= cap).
int64_t rle_encode(const uint8_t* flat, int64_t n, int64_t* counts, int64_t cap) {
    int64_t k = 0;
    uint8_t cur = 0;  // counts start with a zero-run
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = flat[i] != 0;
        if (v == cur) {
            ++run;
        } else {
            if (k >= cap) return -1;
            counts[k++] = run;
            cur = v;
            run = 1;
        }
    }
    if (k >= cap) return -1;
    counts[k++] = run;
    return k;
}

// Encode a full (h, w) canvas that is zero everywhere EXCEPT a
// row-major (ch, cw) crop window placed at (y0, x0), directly into
// column-major run counts — identical output to pasting the window into
// a zero canvas and calling rle_encode, at O(ch*cw + #runs) instead of
// O(h*w) work (and no 100s-of-MB Fortran-order copy on the caller
// side). The eval transport ships survivors as bbox crops
// (evaluation/inference.py), so this is the results.json hot path.
int64_t rle_encode_window(const uint8_t* crop, int64_t ch, int64_t cw,
                          int64_t y0, int64_t x0, int64_t h, int64_t w,
                          int64_t* counts, int64_t cap) {
    if (y0 < 0 || x0 < 0 || y0 + ch > h || x0 + cw > w) return -1;
    int64_t k = 0;
    uint8_t cur = 0;  // counts start with a zero-run
    int64_t run = 0;
    bool overflow = false;
    auto emit = [&](uint8_t v, int64_t len) {
        if (len == 0 || overflow) return;
        if (v == cur) {
            run += len;
        } else if (k >= cap) {
            overflow = true;
        } else {
            counts[k++] = run;
            cur = v;
            run = len;
        }
    };
    emit(0, x0 * h);                       // columns left of the window
    for (int64_t cx = 0; cx < cw; ++cx) {
        emit(0, y0);                       // zeros above
        int64_t y = 0;
        while (y < ch) {                   // window column runs
            uint8_t v = crop[y * cw + cx] != 0;
            int64_t len = 1;
            ++y;
            while (y < ch && (crop[y * cw + cx] != 0) == v) { ++len; ++y; }
            emit(v, len);
        }
        emit(0, h - y0 - ch);              // zeros below
    }
    emit(0, (w - x0 - cw) * h);            // columns right of the window
    if (overflow || k >= cap) return -1;
    counts[k++] = run;                     // final run (as rle_encode)
    return k;
}

// Decode run counts into a column-major uint8 mask buffer of size n.
void rle_decode(const int64_t* counts, int64_t k, uint8_t* flat, int64_t n) {
    int64_t pos = 0;
    uint8_t v = 0;
    for (int64_t i = 0; i < k && pos < n; ++i) {
        int64_t run = counts[i];
        if (run > n - pos) run = n - pos;
        if (v) memset(flat + pos, 1, (size_t)run);
        else memset(flat + pos, 0, (size_t)run);
        pos += run;
        v ^= 1;
    }
    if (pos < n) memset(flat + pos, 0, (size_t)(n - pos));
}

// Total foreground area of a run list.
int64_t rle_area(const int64_t* counts, int64_t k) {
    int64_t a = 0;
    for (int64_t i = 1; i < k; i += 2) a += counts[i];
    return a;
}

// Intersection of two run lists over the same canvas (merge walk, no
// bitmap). Returns |A & B|.
int64_t rle_intersection(const int64_t* a, int64_t ka, const int64_t* b, int64_t kb) {
    int64_t ia = 0, ib = 0;
    int64_t pa = 0, pb = 0;         // absolute end of current run
    uint8_t va = 0, vb = 0;         // current run values
    int64_t ea = (ka > 0) ? a[0] : 0;
    int64_t eb = (kb > 0) ? b[0] : 0;
    int64_t pos = 0, inter = 0;
    while (ia < ka && ib < kb) {
        int64_t stop = (ea < eb) ? ea : eb;
        if (va && vb) inter += stop - pos;
        pos = stop;
        if (ea == stop) { ++ia; va ^= 1; if (ia < ka) ea += a[ia]; }
        if (eb == stop) { ++ib; vb ^= 1; if (ib < kb) eb += b[ib]; }
    }
    (void)pa; (void)pb;
    return inter;
}

// COCO compressed-counts string codec: chars '0'..'o' carry 5 value bits +
// 1 continuation bit (value = char - 48), least-significant group first,
// sign-extended from bit 4 of the last group; counts are difference-coded
// from the 3rd element on (pycocotools rleToString/rleFrString semantics,
// reimplemented from the format spec in data/rle.py). This is the
// per-frame hot path of results.json writing and annotation parsing — the
// Python loop is per-character.
//
// Returns chars written (<= cap), or -1 if cap is too small.
int64_t rle_counts_to_string(const int64_t* counts, int64_t k, char* out,
                             int64_t cap) {
    int64_t n = 0;
    for (int64_t i = 0; i < k; ++i) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1F;
            x >>= 5;  // arithmetic shift: sign-propagates for negatives
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            if (n >= cap) return -1;
            out[n++] = (char)(c + 48);
        }
    }
    return n;
}

// Inverse of rle_counts_to_string. Returns counts written (<= cap), or -1
// on a truncated string / cap overflow.
int64_t rle_string_to_counts(const char* s, int64_t n, int64_t* counts,
                             int64_t cap) {
    int64_t m = 0, i = 0;
    while (i < n) {
        // accumulate in uint64_t: at k=12 a group still shifts into the
        // sign bit, which is signed-overflow UB under gnu++17 — unsigned
        // wraparound is defined and the final cast back is two's-complement
        uint64_t ux = 0;
        int64_t k = 0;
        for (;;) {
            if (i >= n) return -1;
            // 13 five-bit groups cover int64; more means a corrupt or
            // adversarial string — reject instead of shifting by >=64,
            // which is undefined behavior (the Python big-int fallback
            // then reports the real parse error)
            if (k >= 13) return -1;
            int64_t c = (int64_t)(unsigned char)s[i] - 48;
            ux |= (uint64_t)(c & 0x1F) << (5 * k);
            ++i;
            ++k;
            if (!(c & 0x20)) {
                if (c & 0x10 && 5 * k < 64) ux |= ~(uint64_t)0 << (5 * k);
                break;
            }
        }
        int64_t x = (int64_t)ux;
        if (m > 2) x += counts[m - 2];
        if (m >= cap) return -1;
        counts[m++] = x;
    }
    return m;
}

// Batched pairwise track IoU between D detection tracks and G ground-truth
// tracks, each a sequence of T per-frame run lists (ragged, CSR-style):
//   counts:  all runs concatenated
//   offsets: (num_tracks * T + 1) prefix offsets into counts; a frame with
//            offsets[i+1] == offsets[i] is an absent (empty) frame
// Output: ious (D * G) spatio-temporal IoU (sum-inter / sum-union).
void track_iou_matrix(
    const int64_t* d_counts, const int64_t* d_offsets,
    const int64_t* g_counts, const int64_t* g_offsets,
    int64_t d_n, int64_t g_n, int64_t t, double* ious) {
    // precompute per-frame areas
    std::vector<int64_t> d_area((size_t)(d_n * t)), g_area((size_t)(g_n * t));
    for (int64_t i = 0; i < d_n * t; ++i)
        d_area[(size_t)i] = rle_area(d_counts + d_offsets[i], d_offsets[i + 1] - d_offsets[i]);
    for (int64_t i = 0; i < g_n * t; ++i)
        g_area[(size_t)i] = rle_area(g_counts + g_offsets[i], g_offsets[i + 1] - g_offsets[i]);

    for (int64_t di = 0; di < d_n; ++di) {
        for (int64_t gi = 0; gi < g_n; ++gi) {
            int64_t inter = 0, uni = 0;
            for (int64_t f = 0; f < t; ++f) {
                int64_t doff = d_offsets[di * t + f], dlen = d_offsets[di * t + f + 1] - doff;
                int64_t goff = g_offsets[gi * t + f], glen = g_offsets[gi * t + f + 1] - goff;
                int64_t da = d_area[(size_t)(di * t + f)];
                int64_t ga = g_area[(size_t)(gi * t + f)];
                int64_t ix = 0;
                if (dlen > 0 && glen > 0)
                    ix = rle_intersection(d_counts + doff, dlen, g_counts + goff, glen);
                inter += ix;
                uni += da + ga - ix;
            }
            ious[di * g_n + gi] = uni > 0 ? (double)inter / (double)uni : 0.0;
        }
    }
}

// Undo PNG scanline filtering: `data` holds h rows of 1 + stride bytes (the
// filter type, then the filtered bytes), bpp is the bytes of one pixel; the
// h * stride reconstructed bytes go to `out`. Returns -1 when every row's
// filter type is known (0-4), else the index of the first row whose is not.
int64_t png_unfilter(const uint8_t* data, int64_t h, int64_t stride, int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = data + y * (stride + 1);
        const uint8_t ftype = src[0];
        ++src;
        uint8_t* row = out + y * stride;
        const uint8_t* prior = y > 0 ? row - stride : nullptr;
        for (int64_t i = 0; i < stride; ++i) {
            const int a = i >= bpp ? row[i - bpp] : 0;
            const int b = prior ? prior[i] : 0;
            const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
            int pred;
            switch (ftype) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return y;
            }
            row[i] = (uint8_t)(src[i] + pred);
        }
    }
    return -1;
}

}  // extern "C"
