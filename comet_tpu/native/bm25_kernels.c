/* Native BM25 batch scorer.
 *
 * Posting-list scoring is irregular pointer work — the one part of the engine
 * that stays a sequential host loop. Layout: all terms' postings concatenated
 * into flat (docs, tfs) arrays; each query brings (start, len, idf) triples
 * for its terms. Per query: accumulate into a dense score buffer while
 * appending each doc to a candidate list on FIRST touch (every BM25
 * contribution is strictly positive, so buffer==0 identifies first touch); the
 * collect pass then walks the candidate list once — not the postings again —
 * halving the random-access traffic, and zeroes each entry so the buffer
 * is reset for the next query without a 4 MB memset.
 *
 * Scoring formula parity: idf * tf*(k1+1) / (tf + k1*(1-b+b*dl/avgdl)),
 * bm25_index_search.go:299-327. Ties order by (score desc, doc id asc).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef struct {
    float score;
    int32_t doc;
} entry;

/* min-heap ordered by (score asc, doc desc): the root is the WORST kept
 * entry, so a candidate better than the root replaces it. */
static inline int worse(entry a, entry b) {
    if (a.score != b.score) return a.score < b.score;
    return a.doc > b.doc;
}

static void heap_sift_down(entry *h, int n, int i) {
    for (;;) {
        int l = 2 * i + 1, r = l + 1, m = i;
        if (l < n && worse(h[l], h[m])) m = l;
        if (r < n && worse(h[r], h[m])) m = r;
        if (m == i) return;
        entry t = h[i]; h[i] = h[m]; h[m] = t;
        i = m;
    }
}

void bm25_score_topk(
    const int32_t *docs, const float *tfs,
    const int64_t *starts, const int64_t *lens, const float *idfs,
    const int64_t *qoff,          /* [q_n + 1] term ranges per query */
    const float *doc_len, float avgdl, float k1, float b,
    const uint64_t *allowed, int64_t n_docs,
    int q_n, int k,
    float *scores_buf,            /* [n_docs] scratch, caller-zeroed once */
    entry *heap,                  /* [k] scratch */
    int32_t *cand,                /* [n_docs] scratch candidate list */
    int32_t *out_ids, float *out_scores) {
    const float k1p1 = k1 + 1.0f;
    for (int q = 0; q < q_n; ++q) {
        /* accumulate; record each doc on first touch (contributions are
         * strictly positive, so buffer==0 <=> unseen this query) */
        int64_t cn = 0;
        for (int64_t t = qoff[q]; t < qoff[q + 1]; ++t) {
            const int32_t *d = docs + starts[t];
            const float *f = tfs + starts[t];
            const float idf = idfs[t];
            const int64_t len = lens[t];
            for (int64_t i = 0; i < len; ++i) {
                const int32_t doc = d[i];
                /* never trust posting payloads: a corrupt/overflowed doc id
                 * must be skipped, not dereferenced (fuzz: byte-flipped
                 * blobs once segfaulted here via int32-wrapped doc ids) */
                if (doc < 0 || doc >= n_docs) continue;
                const float tf = f[i];
                const float norm = tf + k1 * (1.0f - b + b * doc_len[doc] / avgdl);
                const float s = scores_buf[doc];
                if (s == 0.0f) cand[cn++] = doc;
                scores_buf[doc] = s + idf * tf * k1p1 / norm;
            }
        }
        /* collect: one walk over the unique candidates, zeroing as we go */
        int hn = 0;
        for (int64_t i = 0; i < cn; ++i) {
            const int32_t doc = cand[i];
            const float s = scores_buf[doc];
            scores_buf[doc] = 0.0f;
            if (s == 0.0f) continue;
            if (!((allowed[doc >> 6] >> (doc & 63)) & 1)) continue;
            entry e = {s, doc};
            if (hn < k) {
                /* sift-up insert */
                int i2 = hn++;
                heap[i2] = e;
                while (i2 > 0) {
                    int p = (i2 - 1) >> 1;
                    if (!worse(heap[i2], heap[p])) break;
                    entry tmp = heap[p]; heap[p] = heap[i2]; heap[i2] = tmp;
                    i2 = p;
                }
            } else if (worse(heap[0], e)) {
                heap[0] = e;
                heap_sift_down(heap, hn, 0);
            }
        }
        /* emit sorted best-first by repeated root extraction */
        int32_t *oi = out_ids + (size_t)q * k;
        float *os = out_scores + (size_t)q * k;
        for (int i = 0; i < k; ++i) { oi[i] = -1; os[i] = 0.0f; }
        for (int i = hn - 1; i >= 0; --i) {
            entry root = heap[0];
            hn--;
            heap[0] = heap[hn];
            heap_sift_down(heap, hn, 0);
            oi[i] = root.doc;
            os[i] = root.score;
        }
    }
}
