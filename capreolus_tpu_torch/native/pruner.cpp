// Native block-max span builder for exact dynamic pruning.
//
// The Python/numpy implementation of the per-batch host work (threshold
// estimation + per-range bound accumulation + tile-coarsened span extraction,
// searcher/scoring.py compute_theta/_spans_pruned) costs ~350 us/query —
// more than the device work pruning saves on in-HBM corpora. This C++
// implementation does the same computation in ~10 us/query; the numpy path
// stays as the reference implementation and fallback (equality pinned in
// tests/test_block_max.py). Same role as the reference's reliance on
// Lucene/Anserini for its query-time skip logic
// (capreolus/searcher/anserini.py:151-176), rebuilt natively.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 pruner.cpp -o pruner.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of output spans, or -1 when pruning keeps more than
// (1 - min_tile_savings) of the device tiles (caller falls back to exhaustive).
// Outputs are query-major, matching the numpy span builder.
int64_t ctpu_prune_spans(
    // flattened query terms (query-major)
    const int64_t* q_offsets, int64_t num_queries,  // [Q+1] -> term rows
    const int64_t* tids, const float* w1,           // [T]
    const int64_t* starts, const int64_t* ends,     // [T] full postings spans
    // block-max tables (index/tpu.py build_prune_tables)
    const int64_t* rt_offsets, const int32_t* rt_range,
    const int64_t* rt_start, const int64_t* rt_end,
    const float* rt_max_tf, const float* rt_min_dl,
    const float* gmax_tf, const float* gmin_dl,  // [V] global bounds for table-less terms
    // postings arrays (span-head lookups for the threshold)
    const int32_t* doc_ids, const int32_t* tfs, const int32_t* norm_doclens,
    // scoring parameters
    double k1, double b, double avgdl,
    int64_t num_ranges, int64_t topk, int64_t tile, double min_tile_savings,
    // outputs (caller-allocated; capacity = total full-span tile count + terms)
    int32_t* out_qix, int64_t* out_s, int64_t* out_e, float* out_w1,
    int64_t* out_stats)  // [4] total_lanes, kept_lanes, total_tiles, kept_tiles
{
    std::vector<double> U(num_ranges, 0.0);
    std::vector<int64_t> touched;  // ranges written this query, for cheap reset
    touched.reserve(4096);
    std::vector<std::pair<int32_t, double>> cand;  // (doc, contribution)
    cand.reserve(16384);
    std::vector<double> sums;
    sums.reserve(16384);

    int64_t n_out = 0;
    int64_t total_lanes = 0, kept_lanes = 0, total_tiles = 0, kept_tiles = 0;

    auto contrib = [&](double tf, double dl, double w) {
        return w * tf / (tf + k1 * (1.0 - b + b * dl / avgdl));
    };

    for (int64_t q = 0; q < num_queries; q++) {
        const int64_t t0 = q_offsets[q], t1 = q_offsets[q + 1];

        // ---- threshold: k-th best per-doc sum of span-head contributions
        // (each head is a real posting, so a doc's true score >= its sum)
        cand.clear();
        for (int64_t i = t0; i < t1; i++) {
            const int64_t a = rt_offsets[tids[i]], b_ = rt_offsets[tids[i] + 1];
            for (int64_t e = a; e < b_; e++) {
                const int64_t head = rt_start[e];
                const int32_t doc = doc_ids[head];
                cand.emplace_back(doc, contrib(tfs[head], norm_doclens[doc], w1[i]));
            }
        }
        double theta = -1.0;
        if ((int64_t)cand.size() >= topk) {
            // keep only the top 2k contributions before the doc-dedup sort
            // (same semantics as the numpy path; per-doc sums of any candidate
            // subset are still valid lower bounds). nth_element is O(n) where
            // a full sort of all head candidates dominated the query cost.
            const size_t m = std::min(cand.size(), (size_t)(2 * topk));
            if (cand.size() > m) {
                std::nth_element(cand.begin(), cand.begin() + m, cand.end(),
                                 [](const std::pair<int32_t, double>& x,
                                    const std::pair<int32_t, double>& y) {
                                     return x.second > y.second;
                                 });
                cand.resize(m);
            }
            std::sort(cand.begin(), cand.end());
            sums.clear();
            for (size_t i = 0; i < cand.size();) {
                double s = 0.0;
                const int32_t doc = cand[i].first;
                for (; i < cand.size() && cand[i].first == doc; i++) s += cand[i].second;
                sums.push_back(s);
            }
            if ((int64_t)sums.size() >= topk) {
                std::nth_element(sums.begin(), sums.begin() + (topk - 1), sums.end(),
                                 std::greater<double>());
                theta = sums[topk - 1];
            }
        }

        // ---- per-range upper bounds. Terms WITHOUT block-max tables (df below
        // the index's heavy_df cutoff) charge their GLOBAL bound to every range
        // (accumulated once in u_base rather than written across U), matching
        // the numpy reference (scoring.py _spans_pruned); if no query term has
        // tables at all, nothing can be pruned (numpy: prunable == []).
        double u_base = 0.0;
        bool any_tables = false;
        if (theta > 0.0) {
            for (int64_t r : touched) U[r] = 0.0;
            touched.clear();
            for (int64_t i = t0; i < t1; i++) {
                const int64_t a = rt_offsets[tids[i]], b_ = rt_offsets[tids[i] + 1];
                if (a == b_) {
                    u_base += contrib(gmax_tf[tids[i]], gmin_dl[tids[i]], w1[i]);
                    continue;
                }
                any_tables = true;
                for (int64_t e = a; e < b_; e++) {
                    const int64_t r = rt_range[e];
                    if (U[r] == 0.0) touched.push_back(r);
                    U[r] += contrib(rt_max_tf[e], rt_min_dl[e], w1[i]);
                }
            }
        }
        const bool prune = theta > 0.0 && any_tables;

        // ---- emit tile-coarsened surviving spans (strict skip below theta,
        // with the same f32-vs-f64 safety margin as the numpy path)
        for (int64_t i = t0; i < t1; i++) {
            const int64_t s_full = starts[i], e_full = ends[i];
            total_lanes += e_full - s_full;
            total_tiles += (e_full - 1) / tile - s_full / tile + 1;
            if (!prune) {
                out_qix[n_out] = (int32_t)q;
                out_s[n_out] = s_full;
                out_e[n_out] = e_full;
                out_w1[n_out] = w1[i];
                n_out++;
                kept_lanes += e_full - s_full;
                kept_tiles += (e_full - 1) / tile - s_full / tile + 1;
                continue;
            }
            const int64_t a = rt_offsets[tids[i]], b_ = rt_offsets[tids[i] + 1];
            if (a == b_) {  // term without tables: keep its full span (exactness)
                out_qix[n_out] = (int32_t)q;
                out_s[n_out] = s_full;
                out_e[n_out] = e_full;
                out_w1[n_out] = w1[i];
                n_out++;
                kept_lanes += e_full - s_full;
                kept_tiles += (e_full - 1) / tile - s_full / tile + 1;
                continue;
            }
            int64_t cur_s = -1, cur_e = -1;
            for (int64_t e = a; e < b_; e++) {
                if ((U[rt_range[e]] + u_base) * (1.0 + 1e-5) + 1e-6 < theta) continue;
                kept_lanes += rt_end[e] - rt_start[e];
                // snap outward to the global tile grid
                int64_t ts = std::max(s_full, (rt_start[e] / tile) * tile);
                int64_t te = std::min(e_full, ((rt_end[e] - 1) / tile + 1) * tile);
                if (cur_s < 0) {
                    cur_s = ts; cur_e = te;
                } else if (ts <= cur_e) {
                    cur_e = std::max(cur_e, te);
                } else {
                    out_qix[n_out] = (int32_t)q; out_s[n_out] = cur_s; out_e[n_out] = cur_e;
                    out_w1[n_out] = w1[i]; n_out++;
                    kept_tiles += (cur_e - 1) / tile - cur_s / tile + 1;
                    cur_s = ts; cur_e = te;
                }
            }
            if (cur_s >= 0) {
                out_qix[n_out] = (int32_t)q; out_s[n_out] = cur_s; out_e[n_out] = cur_e;
                out_w1[n_out] = w1[i]; n_out++;
                kept_tiles += (cur_e - 1) / tile - cur_s / tile + 1;
            }
        }
    }

    out_stats[0] = total_lanes;
    out_stats[1] = kept_lanes;
    out_stats[2] = total_tiles;
    out_stats[3] = kept_tiles;
    if (kept_tiles > (int64_t)((1.0 - min_tile_savings) * total_tiles)) return -1;
    return n_out;
}

}  // extern "C"
