// Native host glue for hyperspace_tpu.
//
// The reference delegates host-side heavy lifting to Spark's JVM engine;
// this framework's host path is Python + pyarrow, with the per-value
// dictionary hashing (the one O(values * bytes) pure-Python loop) done
// here. Exposed via a plain C ABI and loaded with ctypes — no pybind11
// dependency.
//
// Functions operate on Arrow string-array layout: a contiguous UTF-8 data
// buffer plus (n+1) int offsets.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Per-bucket sorted merge join over int64 keys laid out bucket-major
// (both sides sorted within each bucket — the covering-index layout).
// Classic run-merge: for each run of equal left keys, bracket the equal
// right run once; inner emits the cross product, left_outer emits one
// (i, -1) row per unmatched left row.

struct JoinInputs {
    const int64_t* lk;
    const int64_t* rk;
    const int64_t* lb;  // B+1 cumulative left bucket bounds
    const int64_t* rb;  // B+1 cumulative right bucket bounds
    int left_outer;
};

void count_range(const JoinInputs& in, int64_t b0, int64_t b1,
                 int64_t* counts) {
    for (int64_t b = b0; b < b1; ++b) {
        int64_t i = in.lb[b], le = in.lb[b + 1];
        int64_t j = in.rb[b], re = in.rb[b + 1];
        int64_t cnt = 0;
        while (i < le) {
            const int64_t k = in.lk[i];
            while (j < re && in.rk[j] < k) ++j;
            int64_t j2 = j;
            while (j2 < re && in.rk[j2] == k) ++j2;
            int64_t i2 = i;
            while (i2 < le && in.lk[i2] == k) ++i2;
            const int64_t m = j2 - j;
            cnt += m ? m * (i2 - i) : (in.left_outer ? (i2 - i) : 0);
            i = i2;
            j = j2;
        }
        counts[b] = cnt;
    }
}

void fill_range(const JoinInputs& in, int64_t b0, int64_t b1,
                const int64_t* offsets, int32_t* li, int32_t* ri) {
    for (int64_t b = b0; b < b1; ++b) {
        int64_t i = in.lb[b], le = in.lb[b + 1];
        int64_t j = in.rb[b], re = in.rb[b + 1];
        int64_t o = offsets[b];
        while (i < le) {
            const int64_t k = in.lk[i];
            while (j < re && in.rk[j] < k) ++j;
            int64_t j2 = j;
            while (j2 < re && in.rk[j2] == k) ++j2;
            int64_t i2 = i;
            while (i2 < le && in.lk[i2] == k) ++i2;
            if (j2 > j) {
                for (int64_t a = i; a < i2; ++a) {
                    for (int64_t c = j; c < j2; ++c) {
                        li[o] = static_cast<int32_t>(a);
                        ri[o] = static_cast<int32_t>(c);
                        ++o;
                    }
                }
            } else if (in.left_outer) {
                for (int64_t a = i; a < i2; ++a) {
                    li[o] = static_cast<int32_t>(a);
                    ri[o] = -1;
                    ++o;
                }
            }
            i = i2;
            j = j2;
        }
    }
}

// Contiguous bucket ranges balanced by left-row mass.
std::vector<int64_t> split_buckets(const int64_t* lb, int64_t B,
                                   int n_threads) {
    std::vector<int64_t> cuts;
    cuts.push_back(0);
    const int64_t total = lb[B];
    for (int t = 1; t < n_threads; ++t) {
        const int64_t want = total * t / n_threads;
        int64_t b = cuts.back();
        while (b < B && lb[b] < want) ++b;
        cuts.push_back(b);
    }
    cuts.push_back(B);
    return cuts;
}

template <typename Fn>
void run_threaded(const int64_t* lb, int64_t B, int n_threads, Fn fn) {
    if (n_threads <= 1 || B <= 1) {
        fn(0, B);
        return;
    }
    auto cuts = split_buckets(lb, B, n_threads);
    std::vector<std::thread> workers;
    for (size_t t = 0; t + 1 < cuts.size(); ++t) {
        if (cuts[t + 1] > cuts[t]) {
            workers.emplace_back(fn, cuts[t], cuts[t + 1]);
        }
    }
    for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

void bucketed_merge_join_count_i64(const int64_t* lk, const int64_t* rk,
                                   const int64_t* lb, const int64_t* rb,
                                   int64_t B, int left_outer,
                                   int n_threads, int64_t* counts) {
    JoinInputs in{lk, rk, lb, rb, left_outer};
    run_threaded(lb, B, n_threads, [&](int64_t b0, int64_t b1) {
        count_range(in, b0, b1, counts);
    });
}

void bucketed_merge_join_fill_i64(const int64_t* lk, const int64_t* rk,
                                  const int64_t* lb, const int64_t* rb,
                                  int64_t B, int left_outer, int n_threads,
                                  const int64_t* offsets, int32_t* li,
                                  int32_t* ri) {
    JoinInputs in{lk, rk, lb, rb, left_outer};
    run_threaded(lb, B, n_threads, [&](int64_t b0, int64_t b1) {
        fill_range(in, b0, b1, offsets, li, ri);
    });
}

}  // extern "C"

namespace {

// Stable LSD radix scatter of the current permutation by one 16-bit
// digit of `w` (values gathered through the permutation). `hist` is the
// digit histogram, already computed over the full array; `offs` is a
// caller-provided 65536-slot scratch — like the histogram it lives on
// the heap, not this frame: a 512 KB stack array would overflow
// small-stack worker threads (musl/pthread defaults).
void radix_pass_u64(const uint64_t* w, int shift, const int64_t* hist,
                    const int32_t* cur, int32_t* nxt, int64_t n,
                    int64_t* offs) {
    int64_t run = 0;
    for (int d = 0; d < 65536; ++d) {
        offs[d] = run;
        run += hist[d];
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t r = cur[i];
        nxt[offs[(w[r] >> shift) & 0xFFFF]++] = r;
    }
}

// Stable ascending LSD radix over the packed uint64 sort words
// (words[0] most significant), starting from the identity permutation
// in `a` with scratch `b`. Returns whichever buffer holds the final
// order. Shared by the bucketed and plain entry points.
int32_t* radix_words_lsd(const uint64_t* const* words, int32_t n_words,
                         int64_t n, int32_t* a, int32_t* b) {
    std::vector<int64_t> hist(4 * 65536);
    std::vector<int64_t> offs(65536);
    for (int32_t w = n_words - 1; w >= 0; --w) {
        const uint64_t* W = words[w];
        std::fill(hist.begin(), hist.end(), 0);
        int64_t* h0 = hist.data();
        int64_t* h1 = h0 + 65536;
        int64_t* h2 = h1 + 65536;
        int64_t* h3 = h2 + 65536;
        for (int64_t i = 0; i < n; ++i) {
            const uint64_t v = W[i];
            ++h0[v & 0xFFFF];
            ++h1[(v >> 16) & 0xFFFF];
            ++h2[(v >> 32) & 0xFFFF];
            ++h3[v >> 48];
        }
        const int64_t* hs[4] = {h0, h1, h2, h3};
        for (int p = 0; p < 4; ++p) {
            // A digit with a single occupied bin permutes nothing.
            // Constant iff the first non-empty bin holds all n rows.
            const int64_t* h = hs[p];
            bool constant = false;
            for (int d = 0; d < 65536; ++d) {
                if (h[d] == n) { constant = true; break; }
                if (h[d] != 0) break;
            }
            if (!constant) {
                radix_pass_u64(W, 16 * p, h, a, b, n, offs.data());
                std::swap(a, b);
            }
        }
    }
    return a;
}

}  // namespace

extern "C" {

// Stable (bucket, key-words) sort permutation — the index build's host
// lane. `words` are big-endian-significant packed uint64 sort lanes
// (words[0] most significant); rows sort ascending by
// (bucket, words[0], ..., words[n_words-1]), ties keeping input order.
// LSD: radix each word least-significant-first (16-bit digits, constant
// digits skipped via the histogram), then one stable counting pass by
// bucket. Outputs the int32 permutation plus per-bucket [start, end)
// bounds. No device link traffic — this replaces a ~perm-sized D2H
// transfer plus a host lexsort (the round-4 review's rung-1 residual).
void bucket_key_sort_perm(const int32_t* bucket_ids, int64_t n,
                          int64_t num_buckets,
                          const uint64_t* const* words, int32_t n_words,
                          int32_t* perm, int64_t* starts, int64_t* ends) {
    if (n <= 0) {
        for (int64_t d = 0; d < num_buckets; ++d) starts[d] = ends[d] = 0;
        return;
    }
    std::vector<int32_t> cur(n), tmp(n);
    for (int64_t i = 0; i < n; ++i) cur[i] = static_cast<int32_t>(i);
    int32_t* a = radix_words_lsd(words, n_words, n, cur.data(), tmp.data());
    // Final stable counting pass by bucket id; writes land directly in
    // `perm` when the parity works out, else through tmp.
    std::vector<int64_t> boffs(num_buckets, 0);
    for (int64_t i = 0; i < n; ++i) ++boffs[bucket_ids[i]];
    int64_t run = 0;
    for (int64_t d = 0; d < num_buckets; ++d) {
        starts[d] = run;
        run += boffs[d];
        ends[d] = run;
        boffs[d] = starts[d];
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t r = a[i];
        perm[boffs[bucket_ids[r]]++] = r;
    }
}

// Plain (no-bucket) stable key-words sort permutation — the entry the
// host ORDER BY and group-encode lanes use. Skips the bucket counting
// pass entirely (a memcpy of the final buffer replaces it), and lets
// the Python side skip allocating an O(n) all-zeros bucket-id array.
void key_sort_perm_u64(int64_t n, const uint64_t* const* words,
                       int32_t n_words, int32_t* perm) {
    if (n <= 0) return;
    std::vector<int32_t> cur(n), tmp(n);
    for (int64_t i = 0; i < n; ++i) cur[i] = static_cast<int32_t>(i);
    int32_t* a = radix_words_lsd(words, n_words, n, cur.data(), tmp.data());
    std::memcpy(perm, a, static_cast<size_t>(n) * sizeof(int32_t));
}

}  // extern "C"

extern "C" {

// FNV-1a 64-bit over each of n strings; identical to the Python
// implementation in io/columnar.py (_string_hash64) — the device bucket
// layout depends on this exact hash.
void fnv1a64_batch_i32(const uint8_t* data, const int32_t* offsets,
                       int64_t n, uint64_t* out) {
    const uint64_t kOffset = 0xCBF29CE484222325ULL;
    const uint64_t kPrime = 0x100000001B3ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = kOffset;
        for (int32_t j = offsets[i]; j < offsets[i + 1]; ++j) {
            h = (h ^ data[j]) * kPrime;
        }
        out[i] = h;
    }
}

void fnv1a64_batch_i64(const uint8_t* data, const int64_t* offsets,
                       int64_t n, uint64_t* out) {
    const uint64_t kOffset = 0xCBF29CE484222325ULL;
    const uint64_t kPrime = 0x100000001B3ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = kOffset;
        for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
            h = (h ^ data[j]) * kPrime;
        }
        out[i] = h;
    }
}

}  // extern "C"
