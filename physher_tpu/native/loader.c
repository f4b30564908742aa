/* Native data-loader kernels: FASTA scan, sequence encoding, site-pattern
 * compression.
 *
 * Native rebuild of the reference's C data layer (reference:
 * src/phyc/sequenceio.c FASTA/NEXUS/Phylip readers, src/phyc/sitepattern.c:87
 * new_SitePattern alignment->pattern compression, src/phyc/sequence.c).
 * The host-side data pipeline stays native so alignment ingestion never
 * bottlenecks device feeding; Python binds via ctypes
 * (physher_tpu/native/__init__.py) with a NumPy fallback.
 *
 * Build: cc -O3 -shared -fPIC loader.c -o _native_loader.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* -- sequence encoding ---------------------------------------------------- */

/* Encode `len` characters through a 256-entry code table into out. */
void encode_sequence(const char *seq, int64_t len, const uint8_t *table,
                     uint8_t *out) {
    for (int64_t i = 0; i < len; i++) {
        out[i] = table[(uint8_t)seq[i]];
    }
}

/* -- FASTA parsing --------------------------------------------------------- */

/* First pass over a FASTA buffer: count sequences and the maximum residue
 * length, so the caller can allocate exact output buffers. */
void fasta_scan(const char *buf, int64_t n, int64_t *n_seqs,
                int64_t *max_len) {
    int64_t count = 0, maxlen = 0, cur = 0;
    int in_header = 0;
    for (int64_t i = 0; i < n; i++) {
        char c = buf[i];
        if (c == '>') {
            if (count > 0 && cur > maxlen) maxlen = cur;
            cur = 0;
            count++;
            in_header = 1;
        } else if (c == '\n' || c == '\r') {
            in_header = 0;
        } else if (!in_header && c != ' ' && c != '\t') {
            cur++;
        }
    }
    if (cur > maxlen) maxlen = cur;
    *n_seqs = count;
    *max_len = maxlen;
}

/* Second pass: extract names (NUL-joined) and residues encoded through
 * `table` into a dense [n_seqs, max_len] matrix (0xFF padding). Returns the
 * number of sequences written. */
int64_t fasta_parse(const char *buf, int64_t n, const uint8_t *table,
                    int64_t max_len, char *names, int64_t names_cap,
                    uint8_t *enc, int64_t *lengths) {
    int64_t si = -1, cur = 0, ni = 0;
    int in_header = 0;
    for (int64_t i = 0; i < n; i++) {
        char c = buf[i];
        if (c == '>') {
            si++;
            cur = 0;
            in_header = 1;
            if (si > 0 && ni < names_cap) names[ni++] = '\0';
        } else if (c == '\n' || c == '\r') {
            in_header = 0;
        } else if (in_header) {
            if (ni < names_cap - 1) names[ni++] = c;
        } else if (c != ' ' && c != '\t') {
            if (si >= 0 && cur < max_len) {
                enc[si * max_len + cur] = table[(uint8_t)c];
                cur++;
                lengths[si] = cur;
            }
        }
    }
    if (ni < names_cap) names[ni] = '\0';
    return si + 1;
}

/* -- site-pattern compression ---------------------------------------------- */

/* FNV-1a hash of one alignment column (stride = L, the row length). */
static uint64_t col_hash(const uint8_t *enc, int64_t T, int64_t L,
                         int64_t col) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t t = 0; t < T; t++) {
        h ^= enc[t * L + col];
        h *= 1099511628211ULL;
    }
    return h;
}

static int col_eq(const uint8_t *enc, int64_t T, int64_t L, int64_t a,
                  int64_t b) {
    for (int64_t t = 0; t < T; t++) {
        if (enc[t * L + a] != enc[t * L + b]) return 0;
    }
    return 1;
}

/* Compress alignment columns into unique patterns.
 *
 * enc: [T, L] row-major encoded alignment.
 * Outputs: indexes[L] (pattern id per site), weights[<=L] (f64 counts),
 * first[<=L] (site index of each pattern's first occurrence).
 * Returns the number of unique patterns (the reference's SitePattern size,
 * sitepattern.c:87-185).
 */
int64_t compress_patterns(const uint8_t *enc, int64_t T, int64_t L,
                          int32_t *indexes, double *weights, int32_t *first) {
    /* open-addressing hash table over column ids */
    int64_t cap = 1;
    while (cap < 2 * L) cap <<= 1;
    int64_t *slots = (int64_t *)malloc(cap * sizeof(int64_t));
    if (!slots) return -1;
    for (int64_t i = 0; i < cap; i++) slots[i] = -1;

    int64_t n_pat = 0;
    for (int64_t s = 0; s < L; s++) {
        uint64_t h = col_hash(enc, T, L, s) & (uint64_t)(cap - 1);
        int64_t pat = -1;
        while (slots[h] != -1) {
            int64_t cand = slots[h];
            if (col_eq(enc, T, L, (int64_t)first[cand], s)) {
                pat = cand;
                break;
            }
            h = (h + 1) & (uint64_t)(cap - 1);
        }
        if (pat == -1) {
            pat = n_pat++;
            first[pat] = (int32_t)s;
            weights[pat] = 0.0;
            slots[h] = pat;
        }
        indexes[s] = (int32_t)pat;
        weights[pat] += 1.0;
    }
    free(slots);
    return n_pat;
}

/* Gather the unique pattern columns into a dense [T, n_pat] matrix. */
void gather_patterns(const uint8_t *enc, int64_t T, int64_t L,
                     const int32_t *first, int64_t n_pat, uint8_t *out) {
    for (int64_t t = 0; t < T; t++) {
        for (int64_t p = 0; p < n_pat; p++) {
            out[t * n_pat + p] = enc[t * L + first[p]];
        }
    }
}
