// Native host kernels, behind a ctypes ABI (native/__init__.py builds
// this file with g++ -O3 at first use): the host-side passes that stay
// off the device by design (SURVEY §7: "graph cleaning is inherently
// sequential/irregular — accept host execution") — transitive reduction
// (asg_arc_del_trans Overlaps.cpp:5357), chain DP, minimizer sketching,
// overlap-region finishing, anchor collection, k-mer counting, the
// Hi-C vote mapping and the EC round's host DAG pass.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <array>

extern "C" {

// Myers transitive reduction over a CSR arc table (vertex = rid<<1|dir).
// Arrays mirror graph/sg.py's StringGraph columns. Already-reduced arcs
// keep providing reachability within the pass, like the reference.
int64_t ht_trans_reduce(int64_t n_vtx,
                        const int64_t* idx_s, const int64_t* idx_n,
                        const uint32_t* av, const int64_t* alen,
                        const uint8_t* seq_del, uint8_t* del_,
                        int64_t fuzz) {
    std::vector<uint8_t> mark(n_vtx, 0);
    int64_t n_reduced = 0;
    for (int64_t v = 0; v < n_vtx; ++v) {
        int64_t s = idx_s[v], n = idx_n[v];
        if (n == 0) continue;
        if (seq_del[v >> 1]) {
            for (int64_t i = 0; i < n; ++i)
                if (!del_[s + i]) { del_[s + i] = 1; ++n_reduced; }
            continue;
        }
        for (int64_t i = 0; i < n; ++i) mark[av[s + i]] = 1;
        int64_t L = alen[s + n - 1] + fuzz;
        for (int64_t i = 0; i < n; ++i) {
            uint32_t w = av[s + i];
            if (mark[w] != 1) continue;
            int64_t ws = idx_s[w], wn = idx_n[w];
            int64_t li = alen[s + i];
            for (int64_t j = 0; j < wn && alen[ws + j] + li <= L; ++j) {
                uint32_t x = av[ws + j];
                if (mark[x]) mark[x] = 2;
            }
        }
        for (int64_t i = 0; i < n; ++i) {
            uint32_t w = av[s + i];
            if (mark[w] == 2 && !del_[s + i]) { del_[s + i] = 1; ++n_reduced; }
            mark[w] = 0;
        }
    }
    return n_reduced;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Anchor-chain DP, one group at a time (scalar port of
// ops/chain.chain_scores_batch_np — identical scoring, incl. the integer
// Q16/Q4 fixed-point penalty, so results are bit-compatible with the
// numpy mirror AND the int32 TPU kernel; see ops/chain._pen_int_np).

#include <cmath>
#ifdef _OPENMP
#include <omp.h>
#endif

// Exact re-expression of the reference chain DP (lchain_qdp_mcopy_fast,
// Hash_Table.cpp:2097; scoring comput_sc_ch_ec :1515; bandwidth cal_bw
// :1475; quick pre-pass quick_ck_lchain :2007). Groups here are single
// (target, strand) anchor runs, so the reference's strand-segment
// bookkeeping collapses: quick_check either resolves the whole group in
// O(n) or the full DP (backward scan, max_skip break, max_ii fallback)
// runs over all of it.

static const int64_t CHAIN_NEG = -(1LL << 62);

static inline int64_t chain_bw(int64_t sj, int64_t oj, int64_t si,
                               int64_t oi, int64_t bw_q16, int64_t xl,
                               int64_t yl) {
    int64_t sf_s = sj, sf_e = si + 1;
    const int64_t sf_r = xl - sf_e, ot_r = yl - (oi + 1);
    sf_s = (sf_s <= oj) ? 0 : sf_s - oj;
    if (sf_r > ot_r) sf_e += ot_r; else sf_e = xl;
    return ((sf_e - sf_s) * bw_q16) >> 16;
}

static inline int64_t chain_pair_sc(int64_t si, int64_t oi, int64_t spi,
                                    int64_t wi, int64_t sj, int64_t oj,
                                    int64_t bw_q16, int64_t pg_q16,
                                    int64_t pskip_q16, int64_t invbw_q4,
                                    int64_t xl, int64_t yl) {
    const int64_t dq = si - sj;
    if (dq <= 0) return CHAIN_NEG;
    const int64_t dr = oi - oj;
    if (dr <= 0) return CHAIN_NEG;
    const int64_t dd = dr > dq ? dr - dq : dq - dr;
    if (dd > 16 && dd > chain_bw(sj, oj, si, oi, bw_q16, xl, yl))
        return CHAIN_NEG;
    const int64_t dg = dr < dq ? dr : dq;
    int64_t sc = spi < dg ? spi : dg;
    sc = (sc >= wi) ? sc / (wi > 1 ? wi : 1) : 1;
    if (dd || (dg > spi && dg > 0)) {
        const int64_t lin_q4 = (pg_q16 * dd) >> 12;
        const int64_t apen_q4 = (sc * dd * invbw_q4) / (dg > 1 ? dg : 1);
        const int64_t cho = (dd < 4)
            ? (lin_q4 < apen_q4 ? lin_q4 : apen_q4)
            : (lin_q4 > apen_q4 ? lin_q4 : apen_q4);
        sc -= (cho + ((pskip_q16 * dg) >> 12)) >> 4;
    }
    return sc;
}

// returns 1 when the quick pre-pass resolved the group (f/pre final; the
// best index is then the LAST argmax of f), else 0 after the full DP.
extern "C" int64_t ht_chain_dp(
    int64_t n, const int64_t* self_off, const int64_t* t_off,
    const int64_t* span, const int64_t* weight,
    int64_t xl, int64_t yl, int64_t max_iter, int64_t max_skip,
    int64_t max_dis, int64_t quick_check,
    int64_t bw_q16, int64_t pg_q16, int64_t pskip_q16, int64_t invbw_q4,
    int64_t* f, int64_t* pre, int64_t* t) {
    if (n <= 0) return 1;
    // --- quick pre-pass: consecutive-link chain (quick_ck_lchain) ---
    if (quick_check) {
        int64_t msc0 = CHAIN_NEG, msc_i0 = -1, ddt = 0, z;
        pre[0] = -1; f[0] = span[0];
        msc0 = f[0]; msc_i0 = 0;
        for (z = 1; z < n; ++z) {
            const int64_t dq = self_off[z] - self_off[z - 1];
            if (dq <= 0) break;
            const int64_t dr = t_off[z] - t_off[z - 1];
            if (dr <= 0) break;
            const int64_t dd = dr > dq ? dr - dq : dq - dr;
            if (dd > 16 && dd > chain_bw(self_off[z - 1], t_off[z - 1],
                                         self_off[z], t_off[z], bw_q16,
                                         xl, yl))
                break;
            int64_t sc = chain_pair_sc(self_off[z], t_off[z], span[z],
                                       weight[z], self_off[z - 1],
                                       t_off[z - 1], bw_q16, pg_q16,
                                       pskip_q16, invbw_q4, xl, yl);
            sc += f[z - 1];
            if (sc < span[z]) break;
            pre[z] = z - 1; f[z] = sc; ddt += dd;
            if (f[z] >= msc0) { msc0 = f[z]; msc_i0 = z; }
        }
        if (z >= n && msc_i0 == n - 1) {
            if (n >= 2 && ddt > 16 &&
                ddt > chain_bw(self_off[0], t_off[0], self_off[n - 1],
                               t_off[n - 1], bw_q16, xl, yl))
                msc_i0 = -1;
            if (msc_i0 == n - 1) return 1;
        }
    }
    // --- full DP: backward scan + max_skip break + max_ii fallback ---
    for (int64_t i = 0; i < n; ++i) t[i] = -1;
    int64_t st = 0, max_ii = -1;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t si = self_off[i], oi = t_off[i];
        const int64_t spi = span[i], wi = weight[i];
        int64_t max_f = spi, n_skip = 0, max_j = -1, end_j, j;
        if (i - st > max_iter) st = i - max_iter;
        for (j = i - 1; j >= st; --j) {
            int64_t sc = chain_pair_sc(si, oi, spi, wi, self_off[j],
                                       t_off[j], bw_q16, pg_q16,
                                       pskip_q16, invbw_q4, xl, yl);
            if (sc != CHAIN_NEG) {
                sc += f[j];
                if (sc > max_f) {
                    max_f = sc; max_j = j;
                    if (n_skip > 0) --n_skip;
                } else if (t[j] == i) {
                    if (++n_skip > max_skip) break;
                }
                if (pre[j] >= 0) t[pre[j]] = i;
            }
        }
        end_j = j;
        if (max_ii < 0 || si > self_off[max_ii] + max_dis) {
            int64_t mx = CHAIN_NEG;
            max_ii = -1;
            for (j = i - 1; j >= st && si <= max_dis + self_off[j]; --j)
                if (mx < f[j]) { mx = f[j]; max_ii = j; }
        }
        if (max_ii >= 0 && max_ii < end_j) {
            const int64_t tmp = chain_pair_sc(
                si, oi, spi, wi, self_off[max_ii], t_off[max_ii], bw_q16,
                pg_q16, pskip_q16, invbw_q4, xl, yl);
            if (tmp != CHAIN_NEG && max_f < tmp + f[max_ii]) {
                max_f = tmp + f[max_ii]; max_j = max_ii;
            }
        }
        f[i] = max_f; pre[i] = max_j;
        if (max_ii < 0 || (si <= max_dis + self_off[max_ii] &&
                           f[max_ii] < f[i]))
            max_ii = i;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Whole-batch chain scoring + traceback + multi-copy extraction
// (scalar port of ops/chain.chain_dp_group = chain_scores_batch_np +
// extract_chains; identical tie-breaking and mcopy semantics).

static inline int64_t chain_len1(int64_t xs, int64_t xl, int64_t ys,
                                 int64_t yl) {
    // projected overlap length with xs==xe, ys==ye (get_chainLen)
    const int64_t xb = xs <= ys ? 0 : xs - ys;
    const int64_t xr = xl - xs - 1;
    const int64_t yr = yl - ys - 1;
    const int64_t xe2 = (xr <= yr) ? xl - 1 : xs + yr;
    return xe2 - xb + 1;
}

extern "C" int64_t ht_chain_groups(
    int64_t G, const int64_t* off,
    const int64_t* self_off, const int64_t* t_off,
    const int64_t* span, const int64_t* weight,
    const int64_t* xl_g, const int64_t* yl_g,
    int64_t max_iter, int64_t max_skip, int64_t max_dis,
    int64_t quick_check,
    int64_t bw_q16, int64_t pg_q16,
    int64_t pskip_q16, int64_t invbw_q4,
    int64_t mcopy_num, int64_t mcopy_q16,
    int64_t mcopy_khit_cut,
    int64_t* chain_cnt,      // [G]
    int64_t* chain_score,    // [G * mcopy_num]
    int64_t* chain_start,    // [G * mcopy_num] into hit_idx
    int64_t* chain_hits,     // [G * mcopy_num]
    int64_t* hit_idx) {      // [off[G]] local anchor indices
    const int64_t NEG = -(1LL << 62);
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    std::vector<int64_t> f, pre, seg, tbuf;
    std::vector<uint8_t> used;
    std::vector<int64_t> cand;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t g = 0; g < G; ++g) {
        int64_t hit_ptr = off[g];  // each group's chains fit its CSR slice
        const int64_t s = off[g], n = off[g + 1] - off[g];
        chain_cnt[g] = 0;
        if (n == 0) continue;
        const int64_t xl = xl_g[g], yl = yl_g[g];
        f.assign(n, 0); pre.assign(n, -1); used.assign(n, 0);
        tbuf.resize(n);
        const int64_t quick = ht_chain_dp(
            n, self_off + s, t_off + s, span + s, weight + s,
            xl, yl, max_iter, max_skip, max_dis, quick_check,
            bw_q16, pg_q16, pskip_q16, invbw_q4,
            f.data(), pre.data(), tbuf.data());
        int64_t msc = NEG, fmin = f[0];
        for (int64_t i = 0; i < n; ++i) {
            if (f[i] > msc) msc = f[i];
            if (f[i] < fmin) fmin = f[i];
        }
        int64_t msc_i = -1, best_ovl = 0;
        if (quick) {
            // quick-resolved group: best = LAST argmax (quick_ck_lchain's
            // ">=" update), no overlap-length tie-break
            for (int64_t i = 0; i < n; ++i)
                if (f[i] >= msc) msc_i = i;
        } else {
            // full DP: tie -> smaller projected overlap length
            for (int64_t i = 0; i < n; ++i) {
                if (f[i] != msc) continue;
                const int64_t ovl = chain_len1(self_off[s + i], xl,
                                               t_off[s + i], yl);
                if (msc_i < 0 || ovl < best_ovl) { msc_i = i; best_ovl = ovl; }
            }
        }
        // trace best (ascending order in hit_idx)
        auto trace = [&](int64_t end, bool stop_at_used) {
            seg.clear();
            int64_t i = end;
            while (i >= 0) {
                if (used[i]) break;
                seg.push_back(i);
                used[i] = 1;
                i = pre[i];
            }
            (void)stop_at_used;
        };
        trace(msc_i, false);
        const int64_t base = g * mcopy_num;
        chain_score[base] = msc;
        chain_start[base] = hit_ptr;
        chain_hits[base] = (int64_t)seg.size();
        for (int64_t k = (int64_t)seg.size() - 1; k >= 0; --k)
            hit_idx[hit_ptr++] = seg[k];
        chain_cnt[g] = 1;
        const int64_t n_hits0 = (int64_t)seg.size();
        if (mcopy_num > 1 && n_hits0 >= mcopy_khit_cut) {
            const int64_t plus = fmin < 0 ? fmin : 0;
            const int64_t min_sc = ((msc - plus) * mcopy_q16) >> 16;
            cand.clear();
            for (int64_t i = 0; i < n; ++i)
                if (!used[i] && f[i] - plus >= min_sc) cand.push_back(i);
            std::stable_sort(cand.begin(), cand.end(),
                             [&](int64_t a, int64_t b) {
                                 return f[a] > f[b];
                             });
            for (int64_t e : cand) {
                if (chain_cnt[g] >= mcopy_num) break;
                if (used[e]) continue;
                trace(e, true);
                if (seg.empty()) continue;
                const int64_t stop = pre[seg.back()];  // pred of chain head
                const int64_t fpos_e = f[e] - plus;
                const int64_t sc = stop < 0 ? fpos_e : f[e] - f[stop];
                if (sc >= min_sc && (int64_t)seg.size() > 1) {
                    const int64_t slot = base + chain_cnt[g];
                    chain_score[slot] = sc + plus;
                    chain_start[slot] = hit_ptr;
                    chain_hits[slot] = (int64_t)seg.size();
                    for (int64_t k = (int64_t)seg.size() - 1; k >= 0; --k)
                        hit_idx[hit_ptr++] = seg[k];
                    chain_cnt[g]++;
                } else {
                    for (int64_t k : seg) used[k] = 0;
                }
            }
        }
    }
    }  // omp parallel
    return off[G];
}

// ---------------------------------------------------------------------------
// HPC minimizer sketching (scalar port of ops/sketch.py's sketch_read —
// same selection semantics incl. the tail push and high-occ rescue;
// cross-validated bit-identical in tests/test_native.py).

static inline uint64_t yak_h64(uint64_t key) {
    key = ~key + (key << 21);
    key = key ^ (key >> 24);
    key = key + (key << 3) + (key << 8);
    key = key ^ (key >> 14);
    key = key + (key << 2) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

static inline uint32_t ft_count(const uint64_t* fh, const uint16_t* fc,
                                int64_t nft, uint64_t h) {
    if (nft == 0) return 0;
    int64_t lo = 0, hi = nft;
    while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (fh[mid] < h) lo = mid + 1; else hi = mid;
    }
    return (lo < nft && fh[lo] == h) ? (uint32_t)fc[lo] : 0;
}

struct MzEntry {           // one eligible position
    uint32_t c;            // key count (0xFFFFFFFF = dummy)
    uint64_t h;            // key hash
    int64_t cpos;          // compressed position
    int64_t stretch;
};

static inline bool mz_less(uint32_t c1, uint64_t h1, uint32_t c2,
                           uint64_t h2) {       // (c1,h1) < (c2,h2)
    return c1 < c2 || (c1 == c2 && h1 < h2);
}

extern "C" int64_t ht_sketch_many(
    const uint8_t* codes, const int64_t* bounds, int64_t n_reads,
    int64_t k, int64_t w,
    const uint64_t* ft_h, const uint16_t* ft_c, int64_t nft,
    int64_t sample_dist, int32_t is_unique,
    const int64_t* out_off,    // [n_reads+1] per-read output capacity CSR
    uint64_t* out_hash, int64_t* out_pos, uint8_t* out_rev,
    int64_t* out_span, uint32_t* out_cnt,
    int64_t* out_n) {          // [n_reads] emitted per read
    const uint64_t kmask = k >= 64 ? ~0ULL : ((1ULL << k) - 1);
    const uint32_t INFC = 0xFFFFFFFFu;
    int64_t overflow = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        const uint8_t* seq = codes + bounds[r];
        const int64_t n = bounds[r + 1] - bounds[r];
        out_n[r] = 0;
        const int64_t cap = out_off[r + 1] - out_off[r];
        // --- HPC compress (keep run end + run len), N runs split stretch
        std::vector<uint8_t> comp;
        std::vector<int64_t> ends, rl, stretch;
        comp.reserve(n);
        int64_t cur_stretch = 0;
        {
            int64_t i = 0;
            while (i < n) {
                int64_t j = i;
                while (j + 1 < n && seq[j + 1] == seq[i]) ++j;
                if (seq[i] == 4) {
                    ++cur_stretch;
                } else {
                    comp.push_back(seq[i]);
                    ends.push_back(j);
                    rl.push_back(j - i + 1);
                    stretch.push_back(cur_stretch);
                }
                i = j + 1;
            }
        }
        const int64_t L = (int64_t)comp.size();
        if (L < k) continue;
        // --- per-position k-mer data (ending at compressed pos i>=k-1)
        const int64_t nj = L - (k - 1);
        std::vector<uint64_t> hsh(nj);
        std::vector<uint8_t> rev(nj), sym(nj), complete(nj);
        std::vector<int64_t> span(nj);
        std::vector<uint32_t> cnt(nj, 0);
        uint64_t x0 = 0, x1 = 0, x2 = 0, x3 = 0;
        const int shift = (int)(k - 1);
        std::vector<uint8_t> elig(L, 0);
        for (int64_t i = 0; i < (k - 1 < L ? k - 1 : L); ++i) elig[i] = 1;
        for (int64_t i = 0; i < L; ++i) {
            const int c = comp[i];
            x0 = ((x0 << 1) | (uint64_t)(c & 1)) & kmask;
            x1 = ((x1 << 1) | (uint64_t)(c >> 1)) & kmask;
            x2 = (x2 >> 1) | ((uint64_t)(1 - (c & 1)) << shift);
            x3 = (x3 >> 1) | ((uint64_t)(1 - (c >> 1)) << shift);
            if (i < k - 1) continue;
            const int64_t j = i - (k - 1);
            const bool s = (x1 == x3);
            sym[j] = s;
            elig[i] = !s;
            rev[j] = !(x1 < x3);
            hsh[j] = rev[j] ? (yak_h64(x2 & kmask) + yak_h64(x3 & kmask))
                            : (yak_h64(x0) + yak_h64(x1));
            span[j] = ends[i] - (ends[i - (k - 1)] - rl[i - (k - 1)] + 1)
                      + 1;
        }
        // lcount: per-stretch running count of eligible positions
        std::vector<int64_t> lcount(L);
        {
            int64_t run = 0;
            for (int64_t i = 0; i < L; ++i) {
                if (i > 0 && stretch[i] != stretch[i - 1]) run = 0;
                run += elig[i] ? 1 : 0;
                lcount[i] = run;
            }
        }
        for (int64_t j = 0; j < nj; ++j) {
            const int64_t i = j + (k - 1);
            complete[j] = !sym[j] && lcount[i] >= k && span[j] < 256 &&
                          stretch[i] == stretch[i - (k - 1)];
            if (complete[j] && nft)
                cnt[j] = ft_count(ft_h, ft_c, nft, hsh[j]);
        }
        // --- eligible entry sequence with composite keys
        std::vector<MzEntry> ent;
        ent.reserve(L);
        for (int64_t i = 0; i < L; ++i) {
            if (!elig[i]) continue;
            MzEntry m;
            m.c = INFC;
            m.h = ~0ULL;
            m.cpos = i;
            m.stretch = stretch[i];
            const int64_t j = i - (k - 1);
            if (j >= 0 && complete[j]) {
                uint32_t cc = cnt[j];
                bool filtered = cc >= (1u << 28);
                if (is_unique) {
                    if (cc == 0) filtered = true;
                    if (cc == 1) cc = 0;
                }
                if (!filtered) { m.c = cc; m.h = hsh[j]; }
            }
            ent.push_back(m);
        }
        const int64_t ne = (int64_t)ent.size();
        std::vector<uint8_t> emit(ne, 0);
        if (ne >= 1) {
            // window-min per start (trailing window of w entries; windows
            // past the end use the truncated suffix, callers mask them)
            std::vector<uint32_t> wm_c(ne);
            std::vector<uint64_t> wm_h(ne);
            {
                std::vector<int64_t> dq(ne);
                int64_t qh = 0, qt = 0;
                for (int64_t i = ne - 1; i >= 0; --i) {
                    while (qt > qh && dq[qh] > i + w - 1) ++qh;
                    while (qt > qh &&
                           !mz_less(ent[dq[qt - 1]].c, ent[dq[qt - 1]].h,
                                    ent[i].c, ent[i].h)) --qt;
                    dq[qt++] = i;
                    wm_c[i] = ent[dq[qh]].c;
                    wm_h[i] = ent[dq[qh]].h;
                }
            }
            // valid-window sentinel + per-entry max over covering starts
            std::vector<uint32_t> vm_c(ne);
            std::vector<uint64_t> vm_h(ne);
            for (int64_t s = 0; s < ne; ++s) {
                const int64_t e = s + w - 1;
                bool valid = e < ne && ent[s].stretch == ent[e].stretch &&
                             lcount[ent[e].cpos] >= w + k - 1;
                vm_c[s] = valid ? wm_c[s] : 0;
                vm_h[s] = valid ? wm_h[s] : 0;
            }
            {
                std::vector<int64_t> dq(ne);
                int64_t qh = 0, qt = 0;
                for (int64_t i = 0; i < ne; ++i) {
                    while (qt > qh && dq[qh] < i - w + 1) ++qh;
                    while (qt > qh) {
                        const int64_t b = dq[qt - 1];
                        const bool b_less =
                            mz_less(vm_c[b], vm_h[b], vm_c[i], vm_h[i]) ||
                            (vm_c[b] == vm_c[i] && vm_h[b] == vm_h[i]);
                        if (b_less) --qt; else break;
                    }
                    dq[qt++] = i;
                    const int64_t m = dq[qh];
                    if (ent[i].c != INFC && vm_c[m] == ent[i].c &&
                        vm_h[m] == ent[i].h)
                        emit[i] = 1;
                }
            }
        }
        // --- tail push for the read's last stretch ---
        if (ne) {
            const int64_t last_st = ent[ne - 1].stretch;
            int64_t s0 = ne - 1;
            while (s0 > 0 && ent[s0 - 1].stretch == last_st) --s0;
            int64_t t0 = ne - w > s0 ? ne - w : s0;
            uint32_t bc = 0xFFFFFFFFu;
            uint64_t bh = ~0ULL;
            int64_t bi = -1;
            for (int64_t t = t0; t < ne; ++t) {
                if (ent[t].c == INFC) continue;
                if (ent[t].c < bc ||
                    (ent[t].c == bc && ent[t].h <= bh)) {
                    bc = ent[t].c;
                    bh = ent[t].h;
                    bi = t;
                }
            }
            if (bi >= 0) emit[bi] = 1;
        }
        // --- collect, then high-occ rescue ---
        std::vector<int64_t> selv;
        for (int64_t i = 0; i < ne; ++i)
            if (emit[i]) selv.push_back(i);
        const int64_t nm = (int64_t)selv.size();
        std::vector<uint8_t> keep(nm, 1);
        if (nft && sample_dist > w && nm) {
            for (int64_t i = 0; i < nm; ++i)
                keep[i] = ent[selv[i]].c == 0;
            int64_t i = 0;
            while (i < nm) {
                if (keep[i]) { ++i; continue; }
                int64_t jx = i;
                while (jx < nm && !keep[jx]) ++jx;
                const int64_t ps = i > 0 ? ends[ent[selv[i - 1]].cpos] : 0;
                const int64_t pe = jx < nm ? ends[ent[selv[jx]].cpos] : n;
                int64_t m = (int64_t)((double)(pe - ps) / sample_dist
                                      + 0.499);
                if (m > 0) {
                    if (m > 16) m = 16;
                    // lexsort by (cnt, hash), stable; rescue first m
                    std::vector<int64_t> idx;
                    for (int64_t t = i; t < jx; ++t) idx.push_back(t);
                    std::stable_sort(idx.begin(), idx.end(),
                        [&](int64_t a, int64_t b) {
                            const MzEntry& ea = ent[selv[a]];
                            const MzEntry& eb = ent[selv[b]];
                            return ea.c < eb.c ||
                                   (ea.c == eb.c && ea.h < eb.h);
                        });
                    for (int64_t t = 0; t < m && t < (int64_t)idx.size();
                         ++t)
                        if (ent[selv[idx[t]]].c < (uint32_t)(pe - ps))
                            keep[idx[t]] = 1;
                }
                i = jx;
            }
        }
        int64_t wr = 0;
        for (int64_t i = 0; i < nm; ++i) {
            if (!keep[i]) continue;
            if (wr >= cap) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
                overflow = r + 1;
                break;
            }
            const MzEntry& m = ent[selv[i]];
            const int64_t j = m.cpos - (k - 1);
            out_hash[out_off[r] + wr] = hsh[j];
            out_pos[out_off[r] + wr] = ends[m.cpos];
            out_rev[out_off[r] + wr] = rev[j];
            out_span[out_off[r] + wr] = span[j];
            out_cnt[out_off[r] + wr] = cnt[j];
            ++wr;
        }
        out_n[r] = wr;
    }
    return overflow ? -overflow : 0;
}

// ---------------------------------------------------------------------------
// Per-read overlap-region finishing (scalar port of
// overlap/anchors._finish_regions): quota filter per ha_ov_type class
// (~ha_get_candidates_interface's max_n_chain quotas, anchor.cpp:685),
// overlap dedup (~dedup_chains, ecovlp.cpp:2984), final (x_s, y_id)
// order. Emits the kept GLOBAL overlap indices in final order so the
// caller gathers every column flat — no per-read python loops.

static inline int ov_type4(int64_t xs, int64_t xe, int64_t rlen) {
    if (xs == 0 && xe == rlen - 1) return 2;
    if (xs > 0 && xe < rlen - 1) return 3;
    return xs == 0 ? 0 : 1;
}

extern "C" void ht_finish_regions(
    int64_t R, const int64_t* r_ov_off,
    const int64_t* score, const int64_t* x_s, const int64_t* x_e,
    const int64_t* y_id, const uint8_t* rev,
    const int64_t* rlen_of, int64_t max_n_chain,
    int64_t* out_idx,        // [n_ov] capacity; kept indices per read
    int64_t* out_cnt) {      // [R] kept count per read
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    std::vector<int64_t> idx, ord;
    std::vector<uint8_t> keep;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
    for (int64_t r = 0; r < R; ++r) {
        const int64_t o0 = r_ov_off[r], o1 = r_ov_off[r + 1];
        const int64_t n = o1 - o0;
        const int64_t rlen = rlen_of[r];
        idx.resize(n);
        for (int64_t i = 0; i < n; ++i) idx[i] = o0 + i;
        // --- quota filter (mirror of _quota_keep_idx) ---
        if (n > max_n_chain) {
            ord.assign(idx.begin(), idx.end());
            std::stable_sort(ord.begin(), ord.end(),
                             [&](int64_t a, int64_t b) {
                                 return score[a] > score[b];
                             });
            int64_t thresh[4] = {0, 0, 0, 0}, seen[4] = {0, 0, 0, 0};
            for (int64_t k = 0; k < n; ++k) {
                const int64_t i = ord[k];
                const int c = ov_type4(x_s[i], x_e[i], rlen);
                if (++seen[c] == max_n_chain) thresh[c] = score[i];
            }
            if (thresh[0] > 0 || thresh[1] > 0 || thresh[2] > 0 ||
                thresh[3] > 0) {
                int64_t w = 0;
                for (int64_t k = 0; k < n; ++k) {
                    const int64_t i = idx[k];
                    const int c = ov_type4(x_s[i], x_e[i], rlen);
                    if (score[i] >= thresh[c]) idx[w++] = i;
                }
                idx.resize(w);
            }
        }
        // --- dedup (mirror of _dedup_keep_mask) ---
        const int64_t m = (int64_t)idx.size();
        if (m > 1) {
            ord.assign(idx.begin(), idx.end());
            std::stable_sort(ord.begin(), ord.end(),
                             [&](int64_t a, int64_t b) {
                                 const int64_t ka = (y_id[a] << 1) | rev[a];
                                 const int64_t kb = (y_id[b] << 1) | rev[b];
                                 if (ka != kb) return ka < kb;
                                 return score[a] > score[b];
                             });
            keep.assign(m, 1);
            for (int64_t i = 0; i < m; ++i) {
                if (!keep[i]) continue;
                const int64_t a = ord[i];
                const int64_t ka = (y_id[a] << 1) | rev[a];
                for (int64_t j = i + 1; j < m; ++j) {
                    const int64_t b = ord[j];
                    if (((y_id[b] << 1) | rev[b]) != ka) break;
                    if (!keep[j]) continue;
                    const int64_t inter =
                        (x_e[a] < x_e[b] ? x_e[a] : x_e[b]) -
                        (x_s[a] > x_s[b] ? x_s[a] : x_s[b]);
                    const int64_t la = x_e[a] - x_s[a], lb = x_e[b] - x_s[b];
                    const int64_t min_len = (la < lb ? la : lb) + 1;
                    if ((double)inter > 0.5 * (double)min_len) keep[j] = 0;
                }
            }
            int64_t w = 0;
            // keep[] is in ord[] order; restore the per-index mask by
            // compacting ord, then rebuild idx in ORIGINAL order
            std::vector<int64_t>& kept = ord;  // reuse
            for (int64_t i = 0; i < m; ++i)
                if (keep[i]) kept[w++] = ord[i];
            kept.resize(w);
            std::sort(kept.begin(), kept.end());
            idx.assign(kept.begin(), kept.end());
        }
        // --- final order: x_s asc, y_id asc, stable ---
        std::stable_sort(idx.begin(), idx.end(),
                         [&](int64_t a, int64_t b) {
                             if (x_s[a] != x_s[b]) return x_s[a] < x_s[b];
                             return y_id[a] < y_id[b];
                         });
        out_cnt[r] = (int64_t)idx.size();
        for (size_t k = 0; k < idx.size(); ++k) out_idx[o0 + k] = idx[k];
    }
    }  // omp parallel
}

// ---------------------------------------------------------------------------
// Anchor collection (scalar port of overlap/anchors.collect_anchors):
// binary-search each minimizer in the position table, expand postings into
// (tid, rev, qpos, t_off) anchors with occurrence-class weights, sort per
// read by (tid, rev, qpos, t_off).

struct Anchor {
    uint32_t tid;
    uint8_t rev;
    int64_t qpos, t_off, span, w;
};

extern "C" int64_t ht_collect_anchors(
    int64_t n_reads, const int64_t* mz_off,
    const uint64_t* mz_hash, const int64_t* mz_pos,
    const uint8_t* mz_rev, const int64_t* mz_span,
    const int64_t* read_ids,                  // query rid per read slot
    const uint64_t* pt_hash, const int64_t* pt_start,
    const int32_t* pt_count, int64_t n_pt,
    const uint32_t* po_rid, const uint32_t* po_pos,
    const uint8_t* po_rev, const uint16_t* po_span,
    const int64_t* tlens,
    int64_t min_cnt, int64_t max_cnt,
    const int64_t* out_off,                   // per-read capacity CSR
    uint32_t* out_tid, uint8_t* out_rev, int64_t* out_qpos,
    int64_t* out_toff, int64_t* out_span, int64_t* out_w,
    int64_t* out_n) {
    int64_t overflow = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    std::vector<Anchor> buf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        out_n[r] = 0;
        const int64_t rid = read_ids[r];
        const int64_t cap = out_off[r + 1] - out_off[r];
        buf.clear();
        for (int64_t m = mz_off[r]; m < mz_off[r + 1]; ++m) {
            const uint64_t h = mz_hash[m];
            int64_t lo = 0, hi = n_pt;
            while (lo < hi) {
                const int64_t mid = (lo + hi) / 2;
                if (pt_hash[mid] < h) lo = mid + 1; else hi = mid;
            }
            if (lo >= n_pt || pt_hash[lo] != h) continue;
            const int64_t s = pt_start[lo];
            const int64_t c = pt_count[lo];
            // occurrence-class weight
            int64_t w = 1;
            if (c <= min_cnt) w = 2;
            if (c >= max_cnt) {
                const int64_t wh = 1 + (c + (max_cnt << 1) - 1)
                                       / (max_cnt << 1);
                w = (int64_t)std::floor(std::pow((double)wh, 1.1));
            }
            if (w > 0xFFFFFF) w = 0xFFFFFF;
            for (int64_t t = s; t < s + c; ++t) {
                if ((int64_t)po_rid[t] == rid) continue;
                Anchor a;
                a.tid = po_rid[t];
                a.rev = mz_rev[m] != po_rev[t];
                a.qpos = mz_pos[m];
                a.span = mz_span[m];
                a.w = w;
                const int64_t tl = tlens[a.tid];
                a.t_off = a.rev ? tl - 1 - ((int64_t)po_pos[t] + 1
                                            - (int64_t)po_span[t])
                                : (int64_t)po_pos[t];
                buf.push_back(a);
            }
        }
        if ((int64_t)buf.size() > cap) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
            overflow = r + 1;
            continue;
        }
        std::stable_sort(buf.begin(), buf.end(), [](const Anchor& a,
                                                    const Anchor& b) {
            if (a.tid != b.tid) return a.tid < b.tid;
            if (a.rev != b.rev) return a.rev < b.rev;
            if (a.qpos != b.qpos) return a.qpos < b.qpos;
            return a.t_off < b.t_off;
        });
        const int64_t base = out_off[r];
        for (int64_t i = 0; i < (int64_t)buf.size(); ++i) {
            out_tid[base + i] = buf[i].tid;
            out_rev[base + i] = buf[i].rev;
            out_qpos[base + i] = buf[i].qpos;
            out_toff[base + i] = buf[i].t_off;
            out_span[base + i] = buf[i].span;
            out_w[base + i] = buf[i].w;
        }
        out_n[r] = (int64_t)buf.size();
    }
    }  // omp parallel
    return overflow ? -overflow : 0;
}

// ---------------------------------------------------------------------------
// Fused k-mer counting for the filter table (~ha_ft_gen, htab.cpp:1136):
// per-read HPC compress + complete canonical k-mer hashing (same emit rule
// as ht_sketch_many at w=1: !sym, lcount>=k, span<256, one N-stretch),
// straight into a flat buffer, OpenMP-parallel sort, then a unique+count
// scan in place. Replaces the python chunk loop + np.unique (single-thread
// sort + two full copies) in index/pos_table.build_filter_table.

#if defined(_OPENMP)
#include <parallel/algorithm>
#endif

// Enumerate one read's complete canonical HPC k-mer hashes (same emit
// rule as ht_sketch_many at w=1: !sym, lcount>=k, span<256, one
// N-stretch), calling emit(hash) for each.
template <class F>
static void for_read_kmers(const uint8_t* seq, int64_t n, int64_t k,
                           F&& emit) {
    const uint64_t kmask = k >= 64 ? ~0ULL : ((1ULL << k) - 1);
    const int shift = (int)(k - 1);
    // HPC compress (run-end + run-length; N runs split stretch)
    std::vector<uint8_t> comp;
    std::vector<int64_t> ends, rl, stretch;
    comp.reserve(n);
    int64_t cur_stretch = 0;
    {
        int64_t i = 0;
        while (i < n) {
            int64_t j = i;
            while (j + 1 < n && seq[j + 1] == seq[i]) ++j;
            if (seq[i] == 4) {
                ++cur_stretch;
            } else {
                comp.push_back(seq[i]);
                ends.push_back(j);
                rl.push_back(j - i + 1);
                stretch.push_back(cur_stretch);
            }
            i = j + 1;
        }
    }
    const int64_t L = (int64_t)comp.size();
    if (L < k) return;
    uint64_t x0 = 0, x1 = 0, x2 = 0, x3 = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < L; ++i) {
        const int c = comp[i];
        x0 = ((x0 << 1) | (uint64_t)(c & 1)) & kmask;
        x1 = ((x1 << 1) | (uint64_t)(c >> 1)) & kmask;
        x2 = (x2 >> 1) | ((uint64_t)(1 - (c & 1)) << shift);
        x3 = (x3 >> 1) | ((uint64_t)(1 - (c >> 1)) << shift);
        // lcount: eligible (= !sym, with the first k-1 positions
        // eligible by definition) run length within the stretch
        bool sym = false;
        if (i >= k - 1) sym = (x1 == x3);
        if (i > 0 && stretch[i] != stretch[i - 1]) run = 0;
        run += sym ? 0 : 1;
        if (i < k - 1 || sym) continue;
        const int64_t i0 = i - (k - 1);
        const int64_t span = ends[i] - (ends[i0] - rl[i0] + 1) + 1;
        if (run < k || span >= 256 || stretch[i] != stretch[i0])
            continue;
        const bool rv = !(x1 < x3);
        emit(rv ? (yak_h64(x2 & kmask) + yak_h64(x3 & kmask))
                : (yak_h64(x0) + yak_h64(x1)));
    }
}

extern "C" int64_t ht_count_kmers(
    const uint8_t* codes, const int64_t* bounds, int64_t n_reads,
    int64_t k, int32_t do_sort,
    uint64_t* hbuf,       // [bounds[n_reads]] scratch; uniques end up at
                          // the front, sorted. With do_sort == 0 the
                          // compacted UNSORTED hashes stay at the front
                          // and their total is returned; the caller
                          // sorts (numpy's SIMD sort beats
                          // __gnu_parallel's here) then ht_unique_u64.
    uint32_t* out_cnt) {  // [bounds[n_reads]] counts per unique
    std::vector<int64_t> nk(n_reads, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        uint64_t* out = hbuf + bounds[r];   // cap n >= emitted
        int64_t wr = 0;
        for_read_kmers(codes + bounds[r], bounds[r + 1] - bounds[r], k,
                       [&](uint64_t h) { out[wr++] = h; });
        nk[r] = wr;
    }
    // compact (serial; one forward memmove pass over <= total_bases u64)
    int64_t tot = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        if (tot != bounds[r] && nk[r])
            std::memmove(hbuf + tot, hbuf + bounds[r],
                         (size_t)nk[r] * sizeof(uint64_t));
        tot += nk[r];
    }
    if (!do_sort) return tot;
#if defined(_OPENMP)
    __gnu_parallel::sort(hbuf, hbuf + tot);
#else
    std::sort(hbuf, hbuf + tot);
#endif
    int64_t nu = 0;
    for (int64_t i = 0; i < tot;) {
        int64_t j = i;
        while (j < tot && hbuf[j] == hbuf[i]) ++j;
        hbuf[nu] = hbuf[i];
        const int64_t c = j - i;
        out_cnt[nu] = c > 0xFFFFFFFFLL ? 0xFFFFFFFFu : (uint32_t)c;
        ++nu;
        i = j;
    }
    return nu;
}

// Bloom-gated k-mer emission (~yak_bf_insert counting pass 0,
// htab.cpp:74-116): enumerate the chunk's HPC k-mer hashes, route them
// to partitions by the hash TOP bits with a deterministic counting-sort
// scatter, then each OpenMP thread runs the blocked bloom (512-bit
// blocks, 4 probes) over its EXCLUSIVE partition — block index also
// comes from the top bits, so partitions never share a block: no
// atomics, fully deterministic (the reference's per-bucket threading
// gives the same property). A hash is emitted ONLY when all probed
// bits were already set — singletons (mostly sequencing errors) never
// reach the count stage, like the reference's -f pre-filter. `bloom`
// is a caller-owned uint64 array of (1 << words_log2) words persisting
// across chunked calls. Emitted hashes are compacted into hbuf
// (partition-ordered, NOT fully sorted); returns the count.
extern "C" int64_t ht_count_kmers_bloom(
    const uint8_t* codes, const int64_t* bounds, int64_t n_reads,
    int64_t k, uint64_t* bloom, int64_t words_log2, uint64_t* hbuf) {
    const int64_t blocks_log2 = words_log2 - 3;   // 8 words/block
    const int P_LOG2 = blocks_log2 < 6 ? (int)blocks_log2 : 6;
    const int P = 1 << P_LOG2;                    // <= 64 partitions
    const int shift = 64 - P_LOG2;
    std::vector<int64_t> nk(n_reads, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        uint64_t* out = hbuf + bounds[r];
        int64_t wr = 0;
        for_read_kmers(codes + bounds[r], bounds[r + 1] - bounds[r], k,
                       [&](uint64_t h) { out[wr++] = h; });
        nk[r] = wr;
    }
    // per-(read, partition) histogram -> deterministic scatter offsets
    std::vector<int64_t> rp((size_t)n_reads * P, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        const uint64_t* in = hbuf + bounds[r];
        int64_t* row = rp.data() + (size_t)r * P;
        for (int64_t i = 0; i < nk[r]; ++i) row[in[i] >> shift]++;
    }
    std::vector<int64_t> pbase(P + 1, 0);
    {   // partition bases, then per-read cursors within each partition
        std::vector<int64_t> psum(P, 0);
        for (int64_t r = 0; r < n_reads; ++r)
            for (int p = 0; p < P; ++p) psum[p] += rp[(size_t)r * P + p];
        for (int p = 0; p < P; ++p) pbase[p + 1] = pbase[p] + psum[p];
        std::vector<int64_t> cur(pbase.begin(), pbase.end() - 1);
        for (int64_t r = 0; r < n_reads; ++r)
            for (int p = 0; p < P; ++p) {
                const int64_t c = rp[(size_t)r * P + p];
                rp[(size_t)r * P + p] = cur[p];
                cur[p] += c;
            }
    }
    const int64_t tot = pbase[P];
    std::vector<uint64_t> buf2(tot);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
        const uint64_t* in = hbuf + bounds[r];
        int64_t* row = rp.data() + (size_t)r * P;
        for (int64_t i = 0; i < nk[r]; ++i)
            buf2[row[in[i] >> shift]++] = in[i];
    }
    // exclusive-block bloom scan per partition
    std::vector<int64_t> emitted(P, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int p = 0; p < P; ++p) {
        uint64_t* w = buf2.data() + pbase[p];
        int64_t we = 0;
        for (int64_t i = pbase[p]; i < pbase[p + 1]; ++i) {
            const uint64_t h = buf2[i];
            uint64_t* blk = bloom + (h >> (64 - blocks_log2)) * 8;
            const uint64_t m = h * 0x9E3779B97F4A7C15ULL;
            int seen = 1;
            uint64_t probes = m;
            for (int q = 0; q < 4; ++q, probes >>= 9) {
                const uint64_t bit = probes & 511;
                uint64_t* wd = blk + (bit >> 6);
                const uint64_t msk = 1ULL << (bit & 63);
                seen &= (*wd & msk) != 0;
                *wd |= msk;
            }
            if (seen) w[we++] = h;
        }
        emitted[p] = we;
    }
    int64_t ne = 0;
    for (int p = 0; p < P; ++p) {
        std::memcpy(hbuf + ne, buf2.data() + pbase[p],
                    (size_t)emitted[p] * sizeof(uint64_t));
        ne += emitted[p];
    }
    return ne;
}

// In-place unique+count scan over an already-sorted uint64 array.
extern "C" int64_t ht_unique_u64(uint64_t* h, int64_t n,
                                 uint32_t* out_cnt) {
    int64_t nu = 0;
    for (int64_t i = 0; i < n;) {
        int64_t j = i;
        while (j < n && h[j] == h[i]) ++j;
        h[nu] = h[i];
        const int64_t c = j - i;
        out_cnt[nu] = c > 0xFFFFFFFFLL ? 0xFFFFFFFFu : (uint32_t)c;
        ++nu;
        i = j;
    }
    return nu;
}

// -t: bound the OpenMP worker count for every native kernel
// (~the reference's thread_num, CommandLines.cpp:101).
extern "C" void ht_set_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

// ---------------------------------------------------------------------
// Hi-C short-read vote mapping (~hic_short_align, hic.cpp:17016).
// Per read: rolling canonical k-mer hashes, probe the sorted unique-
// anchor table, majority vote over matched k-mers. Mirrors
// phasing/hic.py::_vote_place_batch bit-for-bit (cross-validated).

static inline uint64_t ht_yak_hash64_masked(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = (key + (key << 3) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = (key + (key << 2) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

extern "C" void ht_hic_map(
    const uint8_t* mat, int64_t N, int64_t L, int64_t k,
    const uint64_t* hashes, const int32_t* uid, const int64_t* pos,
    int64_t M, const int64_t* pref16,   // 65537 bucket starts by hash>>48
    double min_frac,
    int64_t* uid_out, int64_t* pos_out, int64_t* cands /* [N,2,3] */) {
    const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    const int shift_hi = 2 * (int)(k - 1);
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < N; ++i) {
        uid_out[i] = -1;
        pos_out[i] = -1;
        int64_t* cd = cands + i * 6;
        cd[0] = cd[1] = cd[3] = cd[4] = -1;
        cd[2] = cd[5] = 0;
        const uint8_t* row = mat + i * L;
        uint64_t f = 0, r = 0;
        int run = 0;                 // consecutive valid bases
        // matched k-mers in scan order: (uid, table index, kmer end)
        std::vector<std::array<int64_t, 3>> hits;
        for (int64_t j = 0; j < L; ++j) {
            uint8_t c = row[j];
            if (c > 3) { run = 0; f = 0; r = 0; continue; }
            f = ((f << 2) | c) & mask;
            r = (r >> 2) | ((uint64_t)(3 - c) << shift_hi);
            if (++run < k) continue;
            uint64_t canon = f < r ? f : r;
            uint64_t h = ht_yak_hash64_masked(canon, mask);
            const uint64_t* lo = hashes + pref16[h >> 48];
            const uint64_t* hi = hashes + pref16[(h >> 48) + 1];
            const uint64_t* p = std::lower_bound(lo, hi, h);
            if (p != hi && *p == h)
                hits.push_back({(int64_t)uid[p - hashes],
                                (int64_t)(p - hashes), j});
        }
        if (hits.empty()) continue;
        // vote counts per uid (few distinct uids per read)
        std::vector<std::array<int64_t, 2>> cnt;   // (uid, count)
        for (auto& h : hits) {
            bool found = false;
            for (auto& c : cnt)
                if (c[0] == h[0]) { ++c[1]; found = true; break; }
            if (!found) cnt.push_back({h[0], 1});
        }
        // rank: count desc, uid asc
        std::sort(cnt.begin(), cnt.end(),
                  [](const std::array<int64_t, 2>& a,
                     const std::array<int64_t, 2>& b) {
                      return a[1] != b[1] ? a[1] > b[1] : a[0] < b[0];
                  });
        int64_t n_hit = (int64_t)hits.size();
        int64_t win_uid = cnt[0][0], win_cnt = cnt[0][1];
        bool placed = (double)win_cnt >= (double)n_hit * min_frac &&
                      (n_hit <= 1 || win_cnt >= 2);
        for (int c = 0; c < 2 && c < (int)cnt.size(); ++c) {
            for (auto& h : hits) {
                if (h[0] != cnt[c][0]) continue;
                cd[c * 3 + 0] = cnt[c][0];
                cd[c * 3 + 1] = pos[h[1]] - h[2];   // implied utg start
                cd[c * 3 + 2] = cnt[c][1];
                if (c == 0 && placed) {
                    uid_out[i] = win_uid;
                    pos_out[i] = pos[h[1]];
                }
                break;
            }
        }
    }
}

// ---------------------------------------------------------------------
// The host DAG pass of an EC round (ec/pipeline.py ``_host_dags``): for
// each read with an ambiguity cluster, the strings its cis overlaps'
// traceback columns (gathered from K1's outputs on the device) imply
// over each cluster range vote on the range, by exact plurality, else
// by the star MSA onto the plurality backbone (~Merge_DAGCon,
// Correct.cpp:5031); the corrected read is then built from the
// device's column decisions with those replacements.  Mirrors the
// plain versions bit for bit: ec/window_align.py
// ``WindowColumns.tracebacks``, ec/consensus.py
// ``dag_cluster_consensus`` and ``consensus_apply``.  One call serves a
// round's reads, longest first, over OpenMP threads; each read writes
// only its own result.

#include <map>
#include <string>

namespace {

// Partial-order bundle walk over an insertion-vote map (mirrors
// ec/consensus.py _ins_bundle_walk bit-for-bit): emit the longest
// prefix every additional symbol of which keeps support above
// occ_exact * n — the Merge_DAGCon bundle merge (Correct.cpp:5031)
// for competing/nested insertion bundles.  Ties -> smallest symbol.
void ins_bundle_walk(const std::map<std::string, int64_t>& m, int64_t n,
                     double occ_exact, std::string& out) {
    std::string pfx;
    for (;;) {
        int64_t wt[256];
        memset(wt, 0, sizeof(wt));
        bool any = false;
        for (const auto& kv : m) {
            const std::string& s = kv.first;
            if (s.size() > pfx.size() &&
                s.compare(0, pfx.size(), pfx) == 0) {
                wt[(uint8_t)s[pfx.size()]] += kv.second;
                any = true;
            }
        }
        if (!any) break;
        int b = 0;
        int64_t mx = -1;
        for (int c = 0; c < 256; ++c)
            if (wt[c] > mx) { mx = wt[c]; b = c; }   // ties: smallest
        if (!((double)mx > occ_exact * (double)n)) break;
        pfx.push_back((char)b);
    }
    out += pfx;
}

// Star-MSA consensus over sorted cluster voter strings (mirrors
// ec/consensus.py _star_msa_consensus bit-for-bit: diagonal > up > left
// traceback; column ties -> smallest symbol; insertion bundles merge
// via the prefix walk above).  The Merge_DAGCon role when exact
// plurality fails.  False where the plain version returns None.
bool star_msa_consensus(const std::vector<std::string>& strs,
                        const std::string& backbone, double occ_exact,
                        int64_t max_backbone, int64_t max_voter,
                        std::string& out) {
    const int64_t n = (int64_t)strs.size();
    const int64_t B = (int64_t)backbone.size();
    if (B == 0 || B > max_backbone) return false;
    std::vector<std::array<int64_t, 5>> sub(
        (size_t)B, std::array<int64_t, 5>{0, 0, 0, 0, 0});
    std::vector<std::map<std::string, int64_t>> ins((size_t)B + 1);
    // backbone homopolymer runs for the deletion-bundle
    // canonicalization (the same-base node merging of Merge_DAGCon,
    // Correct.cpp:4700,4806)
    std::vector<int64_t> run_id((size_t)B, 0);
    for (int64_t i = 1; i < B; ++i)
        run_id[i] = run_id[i - 1] + (backbone[i] != backbone[i - 1]);
    const int64_t n_runs = B ? run_id[B - 1] + 1 : 0;
    std::vector<int64_t> run_len((size_t)n_runs, 0);
    for (int64_t i = 0; i < B; ++i) run_len[run_id[i]]++;
    std::vector<std::map<int64_t, int64_t>> run_sup((size_t)n_runs);
    std::vector<int64_t> lv((size_t)n_runs, 0);
    std::vector<int64_t> dp;
    for (const std::string& s : strs) {
        if ((int64_t)s.size() > max_voter) return false;
        if (s == backbone) {
            for (int64_t i = 0; i < B; ++i)
                sub[i][(uint8_t)backbone[i]]++;
            for (int64_t r = 0; r < n_runs; ++r)
                run_sup[r][run_len[r]]++;
            continue;
        }
        const int64_t m = (int64_t)s.size();
        dp.assign((size_t)((B + 1) * (m + 1)), 0);
        auto D = [&](int64_t i, int64_t j) -> int64_t& {
            return dp[i * (m + 1) + j];
        };
        for (int64_t j = 0; j <= m; ++j) D(0, j) = j;
        for (int64_t i = 0; i <= B; ++i) D(i, 0) = i;
        for (int64_t i = 1; i <= B; ++i)
            for (int64_t j = 1; j <= m; ++j) {
                const int64_t d =
                    D(i - 1, j - 1) + (s[j - 1] != backbone[i - 1]);
                const int64_t u = D(i - 1, j) + 1;
                const int64_t l = D(i, j - 1) + 1;
                D(i, j) = (d <= u && d <= l) ? d : (u <= l ? u : l);
            }
        int64_t i = B, j = m;
        std::string pend;
        auto flush = [&](int64_t at) {
            if (!pend.empty()) {
                std::reverse(pend.begin(), pend.end());
                ins[at][pend]++;
                pend.clear();
            }
        };
        std::fill(lv.begin(), lv.end(), 0);
        while (i > 0 || j > 0) {
            if (i > 0 && j > 0 &&
                D(i, j) == D(i - 1, j - 1) +
                               (s[j - 1] != backbone[i - 1])) {
                flush(i);
                sub[i - 1][(uint8_t)s[j - 1]]++;
                lv[run_id[i - 1]]++;
                --i;
                --j;
            } else if (i > 0 && D(i, j) == D(i - 1, j) + 1) {
                flush(i);
                sub[i - 1][4]++;
                --i;
            } else {
                pend.push_back(s[j - 1]);
                --j;
            }
        }
        flush(0);
        for (int64_t r = 0; r < n_runs; ++r) run_sup[r][lv[r]]++;
    }
    // per-run eligibility + canonical kept length: delete the k-th
    // symbol only when the voters emitting < k symbols clear the
    // column-deletion occ threshold
    std::vector<int64_t> run_start((size_t)n_runs, 0);
    for (int64_t r = 1; r < n_runs; ++r)
        run_start[r] = run_start[r - 1] + run_len[r - 1];
    std::vector<uint8_t> canon((size_t)n_runs, 0);
    std::vector<int64_t> keep_len((size_t)n_runs, 0);
    for (int64_t r = 0; r < n_runs; ++r) {
        const int64_t R = run_len[r];
        if (R < 2) continue;
        const int64_t i0 = run_start[r];
        bool inner_ins = false;
        for (int64_t i = i0 + 1; i < i0 + R && !inner_ins; ++i)
            inner_ins = !ins[i].empty();
        if (inner_ins) continue;
        const int b_r = (uint8_t)backbone[i0];
        bool ok = true;
        for (int64_t i = i0; i < i0 + R && ok; ++i) {
            int w = 0;
            for (int c = 1; c < 5; ++c)
                if (sub[i][c] > sub[i][w]) w = c;
            if (w != b_r && w != 4 &&
                (double)sub[i][w] > occ_exact * n)
                ok = false;
        }
        if (!ok) continue;
        int64_t kept = 0;
        for (int64_t k = 1; k <= R; ++k) {
            int64_t ge_k = 0;
            for (const auto& kv : run_sup[r])
                if (kv.first >= k) ge_k += kv.second;
            if (!((double)(n - ge_k) > occ_exact * n)) kept++;
        }
        canon[r] = 1;
        keep_len[r] = kept;
    }
    out.clear();
    for (int64_t i = 0; i <= B; ++i) {
        if (!ins[i].empty()) ins_bundle_walk(ins[i], n, occ_exact, out);
        if (i < B) {
            const int64_t r = run_id[i];
            if (canon[r]) {
                if (i == run_start[r])
                    out.append((size_t)keep_len[r], backbone[i]);
                continue;
            }
            int w = 0;
            for (int c = 1; c < 5; ++c)
                if (sub[i][c] > sub[i][w]) w = c;
            if ((double)sub[i][w] > occ_exact * n) {
                if (w != 4) out.push_back((char)w);
            } else {
                out.push_back(backbone[i]);
            }
        }
    }
    return true;
}

// Levenshtein distance (ec/consensus.py _edit_distance).
int64_t edit_distance(const uint8_t* a, int64_t na, const std::string& b) {
    const int64_t nb = (int64_t)b.size();
    std::vector<int64_t> prev((size_t)nb + 1), cur((size_t)nb + 1);
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        cur[0] = i;
        for (int64_t j = 1; j <= nb; ++j) {
            const int64_t s = prev[j - 1] + ((uint8_t)b[j - 1] != a[i - 1]);
            cur[j] = std::min(s, std::min(prev[j] + 1, cur[j - 1] + 1));
        }
        std::swap(prev, cur);
    }
    return prev[nb];
}

struct DagIn {
    const int64_t *q_off;
    const uint8_t *q, *subw, *ins_p, *ins_base, *ins_len1, *amb;
    const int64_t *het_off, *het;
    const int64_t *ov_off, *ov_xs, *ov_n;
    const uint8_t *ov_cis, *has_dag;
    const int64_t *seg_off, *seg_o, *seg_col, *seg_n, *seg_src;
    const uint8_t *col_tb, *col_ic, *col_ib;
    int64_t n_col;
    const int64_t *seam_off, *seams;
    int64_t gap, max_ins, max_backbone, max_voter, occ_tot;
    double occ_exact;
};

struct DagRead {
    std::vector<uint8_t> seq;
    std::vector<int64_t> ed_pos, ed_delta;
    int64_t n_edits = 0, n_clusters = 0;
    uint8_t served = 0;
};

struct Repl {
    int64_t s, e;
    std::string r;
};

// dag_cluster_consensus over one read's clusters: the replacements.
// False when a gathered segment or seam falls outside its overlap.
bool dag_clusters(const DagIn& in, int64_t r,
                  const std::vector<std::pair<int64_t, int64_t>>& clusters,
                  std::vector<Repl>& repl) {
    const uint8_t* q = in.q + in.q_off[r];
    const int64_t qlen = in.q_off[r + 1] - in.q_off[r];
    const int64_t o0 = in.ov_off[r], n_ov = in.ov_off[r + 1] - o0;
    const int64_t* xs = in.ov_xs + o0;
    const int64_t* span = in.ov_n + o0;
    const uint8_t* cis = in.ov_cis + o0;
    // WindowColumns.tracebacks over the cis overlaps (the only ones
    // read): every column unaligned (5), then the gathered segments,
    // then the seam insertions
    std::vector<int64_t> base((size_t)n_ov, -1);
    int64_t tot = 0;
    for (int64_t o = 0; o < n_ov; ++o)
        if (cis[o]) { base[o] = tot; tot += span[o]; }
    std::vector<uint8_t> tb((size_t)tot, 5), ic((size_t)tot, 0),
        ib((size_t)tot, 0);
    for (int64_t k = in.seg_off[r]; k < in.seg_off[r + 1]; ++k) {
        const int64_t o = in.seg_o[k], n = in.seg_n[k];
        if (o < 0 || o >= n_ov) return false;
        if (base[o] < 0) continue;
        const int64_t c = in.seg_col[k] - xs[o], src = in.seg_src[k];
        if (c < 0 || n < 0 || c + n > span[o] || src < 0 ||
            src + n > in.n_col)
            return false;
        memcpy(&tb[base[o] + c], in.col_tb + src, (size_t)n);
        memcpy(&ic[base[o] + c], in.col_ic + src, (size_t)n);
        memcpy(&ib[base[o] + c], in.col_ib + src, (size_t)n);
    }
    for (int64_t k = in.seam_off[r]; k < in.seam_off[r + 1]; ++k) {
        const int64_t* sm = in.seams + 4 * k;
        const int64_t o = sm[0], g = sm[2], b = sm[3];
        if (o < 0 || o >= n_ov) return false;
        if (base[o] < 0) continue;
        const int64_t c = sm[1] - xs[o];
        if (c < 0 || c >= span[o]) return false;
        const int64_t t = base[o] + c;
        if (ic[t] == 0) {
            ic[t] = (uint8_t)std::min<int64_t>(g, 255);
            ib[t] = (uint8_t)b;
        } else if (ib[t] == b) {
            ic[t] = (uint8_t)std::min<int64_t>(ic[t] + g, 255);
        }
    }
    std::vector<uint8_t> het((size_t)qlen, 0);
    for (int64_t k = in.het_off[r]; k < in.het_off[r + 1]; ++k)
        if (in.het[k] >= 0 && in.het[k] < qlen) het[in.het[k]] = 1;
    std::vector<std::string> strs;
    std::string qs, cons;
    for (const auto& cl : clusters) {
        // cluster_range: a small context, then homopolymer-run ends
        int64_t cs = std::max<int64_t>(0, cl.first - 2);
        int64_t ce = std::min(qlen, cl.second + 2);
        for (int64_t ext = 0; cs > 0 && q[cs - 1] == q[cs] && ext < 12;
             ++ext)
            --cs;
        for (int64_t ext = 0; ce < qlen && q[ce] == q[ce - 1] && ext < 12;
             ++ext)
            ++ce;
        bool has_het = false;
        for (int64_t p = cs; p < ce && !has_het; ++p) has_het = het[p];
        if (has_het) continue;            // never rewrite het evidence
        strs.clear();
        for (int64_t o = 0; o < n_ov; ++o) {
            if (!cis[o] || xs[o] > cs || xs[o] + span[o] < ce) continue;
            const int64_t lo = base[o] + (cs - xs[o]);
            bool bad = false;
            for (int64_t t = lo; t < lo + (ce - cs) && !bad; ++t)
                bad = tb[t] > 4;          // window not aligned here
            if (bad) continue;
            std::string s;
            for (int64_t t = lo; t < lo + (ce - cs); ++t) {
                if (tb[t] <= 3) s.push_back((char)tb[t]);
                if (ic[t] > 0)
                    s.append((size_t)std::min<int64_t>(ic[t], in.max_ins),
                             (char)(ib[t] <= 3 ? ib[t] : 3));
            }
            strs.push_back(std::move(s));
        }
        qs.clear();
        for (int64_t p = cs; p < ce; ++p)
            qs.push_back((char)(q[p] <= 3 ? q[p] : 3));
        strs.push_back(qs);
        const int64_t n_voters = (int64_t)strs.size();
        if (n_voters < in.occ_tot) continue;
        // plurality: the smallest of the most frequent strings
        std::sort(strs.begin(), strs.end());
        size_t bi = 0, bc = 0;
        for (size_t i = 0; i < strs.size();) {
            size_t j = i;
            while (j < strs.size() && strs[j] == strs[i]) ++j;
            if (j - i > bc) { bc = j - i; bi = i; }
            i = j;
        }
        if ((double)bc > in.occ_exact * (double)n_voters) {
            if (strs[bi] != qs) repl.push_back({cs, ce, strs[bi]});
            continue;
        }
        if (star_msa_consensus(strs, strs[bi], in.occ_exact,
                               in.max_backbone, in.max_voter, cons) &&
            !cons.empty() && cons != qs)
            repl.push_back({cs, ce, cons});
    }
    return true;
}

// consensus_apply: the corrected read from the column decisions and
// the replacements (column edits inside a replaced range suppressed).
void dag_apply(const DagIn& in, int64_t r, std::vector<Repl>& repl,
               DagRead& out) {
    const uint8_t* q = in.q + in.q_off[r];
    const int64_t q0 = in.q_off[r], qlen = in.q_off[r + 1] - q0;
    std::vector<uint8_t> ps((size_t)qlen), pi((size_t)qlen);
    for (int64_t p = 0; p < qlen; ++p) {
        ps[p] = in.subw[q0 + p] != 15;
        pi[p] = in.ins_p[q0 + p] != 0;
    }
    std::sort(repl.begin(), repl.end(), [](const Repl& a, const Repl& b) {
        if (a.s != b.s) return a.s < b.s;
        if (a.e != b.e) return a.e < b.e;
        return a.r < b.r;
    });
    for (const Repl& x : repl)
        for (int64_t p = x.s; p < x.e; ++p) ps[p] = pi[p] = 0;
    std::vector<int64_t> change;
    for (int64_t p = 0; p < qlen; ++p)
        if (ps[p] || pi[p]) change.push_back(p);
    auto& seq = out.seq;
    seq.reserve((size_t)qlen + 64);
    auto take = [&](int64_t a, int64_t b) {      // q[a:b]
        if (b > a) seq.insert(seq.end(), q + a, q + b);
    };
    if (change.empty() && repl.empty()) {
        take(0, qlen);
        return;
    }
    std::vector<uint8_t> qc;
    int64_t prev = 0;
    size_t ci = 0, ri = 0;
    while (ci < change.size() || ri < repl.size()) {
        if (ri < repl.size() &&
            (ci >= change.size() || repl[ri].s <= change[ci])) {
            const Repl& x = repl[ri++];
            take(prev, x.s);
            seq.insert(seq.end(), x.r.begin(), x.r.end());
            qc.assign(q + x.s, q + x.e);
            for (auto& v : qc) v = v <= 3 ? v : 3;
            out.n_edits += edit_distance(qc.data(), x.e - x.s, x.r);
            const int64_t d = (int64_t)x.r.size() - (x.e - x.s);
            if (d != 0) {
                out.ed_pos.push_back(x.e);
                out.ed_delta.push_back(d);
            }
            prev = x.e;
            continue;
        }
        const int64_t p = change[ci++];
        take(prev, p);
        if (ps[p]) {
            const uint8_t w = in.subw[q0 + p];
            if (w != 4) {                        // substitution
                seq.push_back(w);
            } else {                             // query base deleted
                out.ed_pos.push_back(p + 1);
                out.ed_delta.push_back(-1);
            }
            out.n_edits += 1;
        } else {
            seq.push_back(q[p]);
        }
        if (pi[p]) {
            const int64_t n = (int64_t)in.ins_len1[q0 + p] + 1;
            seq.insert(seq.end(), (size_t)n, in.ins_base[q0 + p]);
            out.n_edits += n;
            out.ed_pos.push_back(p + 1);
            out.ed_delta.push_back(n);
        }
        prev = p + 1;
    }
    take(prev, qlen);
}

// _host_dag of one read.
bool dag_read(const DagIn& in, int64_t r, DagRead& out) {
    const uint8_t* amb = in.amb + in.q_off[r];
    const int64_t qlen = in.q_off[r + 1] - in.q_off[r];
    // _ambiguity_clusters: ambiguous columns within ``gap`` bases
    std::vector<std::pair<int64_t, int64_t>> clusters;
    int64_t s = -1, last = -1;
    for (int64_t p = 0; p < qlen; ++p) {
        if (!amb[p]) continue;
        if (s < 0) {
            s = p;
        } else if (p - last > in.gap) {
            clusters.push_back({s, last + 1});
            s = p;
        }
        last = p;
    }
    if (s >= 0) clusters.push_back({s, last + 1});
    out.n_clusters = (int64_t)clusters.size();
    out.served = in.has_dag[r];
    std::vector<Repl> repl;
    if (in.has_dag[r] && !dag_clusters(in, r, clusters, repl)) return false;
    dag_apply(in, r, repl, out);
    return true;
}

struct DagRound {
    std::vector<DagRead> reads;
};

}  // namespace

// One round's host DAG pass over ``n_reads`` reads; returns a handle
// to the results (``ht_dag_take`` copies them out and frees it), or
// null when a gathered segment or seam lies outside its overlap.
// ``res`` [n_reads, 5]: corrected length, edit count, (pos, delta)
// events, clusters, whether the read had its columns.  ``params``:
// cluster gap, MAX_INS_TRACK, MSA_MAX_BACKBONE, MSA_MAX_VOTER, occ_tot.
extern "C" void* ht_dag_reads(
    int64_t n_reads, const int64_t* q_off, const uint8_t* q,
    const uint8_t* subw, const uint8_t* ins_p, const uint8_t* ins_base,
    const uint8_t* ins_len1, const uint8_t* amb,
    const int64_t* het_off, const int64_t* het,
    const int64_t* ov_off, const int64_t* ov_xs, const int64_t* ov_n,
    const uint8_t* ov_cis, const uint8_t* has_dag,
    const int64_t* seg_off, const int64_t* seg_o, const int64_t* seg_col,
    const int64_t* seg_n, const int64_t* seg_src,
    const uint8_t* col_tb, const uint8_t* col_ic, const uint8_t* col_ib,
    int64_t n_col, const int64_t* seam_off, const int64_t* seams,
    const int64_t* params, double occ_exact, int32_t n_threads,
    int64_t* res) {
    const DagIn in{q_off, q, subw, ins_p, ins_base, ins_len1, amb,
                   het_off, het, ov_off, ov_xs, ov_n, ov_cis, has_dag,
                   seg_off, seg_o, seg_col, seg_n, seg_src,
                   col_tb, col_ic, col_ib, n_col, seam_off, seams,
                   params[0], params[1], params[2], params[3], params[4],
                   occ_exact};
    auto* h = new DagRound;
    h->reads.resize((size_t)n_reads);
    std::vector<int64_t> order((size_t)n_reads);
    for (int64_t i = 0; i < n_reads; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return q_off[a + 1] - q_off[a] > q_off[b + 1] - q_off[b];
    });
    int bad = 0;
#pragma omp parallel for schedule(dynamic, 1) num_threads(n_threads > 0 ? n_threads : 1)
    for (int64_t i = 0; i < n_reads; ++i) {
        const int64_t r = order[i];
        if (!dag_read(in, r, h->reads[r])) {
#pragma omp atomic write
            bad = 1;
        }
    }
    if (bad) {
        delete h;
        return nullptr;
    }
    for (int64_t r = 0; r < n_reads; ++r) {
        const DagRead& d = h->reads[r];
        res[5 * r + 0] = (int64_t)d.seq.size();
        res[5 * r + 1] = d.n_edits;
        res[5 * r + 2] = (int64_t)d.ed_pos.size();
        res[5 * r + 3] = d.n_clusters;
        res[5 * r + 4] = d.served;
    }
    return h;
}

// Copy a round's results out, read after read (corrected codes, edit
// positions, edit deltas), and free the handle.
extern "C" void ht_dag_take(void* handle, uint8_t* seq, int64_t* ed_pos,
                            int64_t* ed_delta) {
    auto* h = static_cast<DagRound*>(handle);
    for (const DagRead& d : h->reads) {
        if (!d.seq.empty()) memcpy(seq, d.seq.data(), d.seq.size());
        seq += d.seq.size();
        for (size_t k = 0; k < d.ed_pos.size(); ++k) {
            *ed_pos++ = d.ed_pos[k];
            *ed_delta++ = d.ed_delta[k];
        }
    }
    delete h;
}
