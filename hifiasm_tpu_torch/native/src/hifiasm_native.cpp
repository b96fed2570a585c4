// Native host kernels for graph pointer-chasing passes.
//
// The device (JAX/Pallas) owns the compute path; these C++ kernels cover
// the host-side irregular passes that stay off-device by design (SURVEY
// §7: "graph cleaning is inherently sequential/irregular — accept host
// execution"), replacing the reference's same-purpose C++
// (asg_arc_del_trans Overlaps.cpp:5357, the ma_hit_sub event sweep
// :1931) behind a ctypes ABI. Built by native/build.py with g++ -O3.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <array>
#include <map>
#include <string>

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

// Longest >=min_dp coverage subregion per read (~ma_hit_sub event sweep).
// events: per read a [qs*2, qe*2+1] list; CSR offsets ev_off per read.
void ht_coverage_sub(int64_t n_reads, const int64_t* ev_off,
                     int64_t* events /* sorted in-place per read */,
                     int64_t min_dp, int64_t* out_s, int64_t* out_e) {
    for (int64_t r = 0; r < n_reads; ++r) {
        int64_t a = ev_off[r], b = ev_off[r + 1];
        std::sort(events + a, events + b);
        int64_t dp = 0, start = 0, bs = 0, be = 0;
        for (int64_t i = a; i < b; ++i) {
            int64_t x = events[i];
            int64_t old = dp;
            dp += (x & 1) ? -1 : 1;
            if (old < min_dp && dp >= min_dp) start = x >> 1;
            else if (old >= min_dp && dp < min_dp) {
                int64_t len = (x >> 1) - start;
                if (len > be - bs) { bs = start; be = x >> 1; }
            }
        }
        out_s[r] = bs;
        out_e[r] = be;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded bit-parallel Myers alignment, host batch engine.
//
// Scalar-per-problem port of ops/banded_batch.banded_batch_np (same
// semantics as the scalar oracle banded_edit_np; cross-validated in
// tests/test_native.py): band 2e+1 <= 63 bits in one uint64, x aligned
// globally, free y-start in [0,2e], free y-end in [xlen, xlen+2e].
// Traceback emits the consensus-ready per-x encoding (tb/ins_cnt/ins_base).
// ~200k windows/s/core vs ~2.4k for the numpy engine.

extern "C" int64_t ht_banded_batch(
    int64_t B, int64_t XL, int64_t YL,
    const uint8_t* x, const int64_t* xlen,
    const uint8_t* y, const int64_t* ylen,
    int64_t e, int32_t* err_out, int32_t* ys_out, int32_t* yn_out,
    uint8_t* tb_out, uint8_t* ic_out, uint8_t* ib_out, int32_t traceback) {
    const int W = int(2 * e + 1);
    const uint64_t mask = (W >= 64) ? ~0ULL : ((1ULL << W) - 1);
    int64_t stuck = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    std::vector<uint64_t> st_vp, st_d0, st_hp;
    if (traceback) {
        st_vp.resize(XL + 1);
        st_d0.resize(XL + 1);
        st_hp.resize(XL + 1);
    }
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* xb = x + b * XL;
        const uint8_t* yb = y + b * YL;
        const int64_t tl = xlen[b], pl = ylen[b];
        uint8_t* tbp = tb_out + b * XL;
        uint8_t* icp = ic_out + b * XL;
        uint8_t* ibp = ib_out + b * XL;
        if (traceback) {
            memset(tbp, 5, XL);
            memset(icp, 0, XL);
            memset(ibp, 0, XL);
        }
        if (tl == 0) { err_out[b] = 0; ys_out[b] = 0; yn_out[b] = 0; continue; }
        uint64_t peq[5] = {0, 0, 0, 0, 0};
        const int64_t w0 = W < pl ? W : pl;
        for (int64_t i = 0; i < w0; ++i) peq[yb[i]] |= 1ULL << i;
        uint64_t VP = 0, VN = 0;
        int64_t err = 0;
        for (int64_t i = 0; i < tl; ++i) {
            const uint64_t Eq = xb[i] < 4 ? peq[xb[i]] : 0;
            const uint64_t X = Eq | VN;
            const uint64_t D0 = (((VP + (X & VP)) & mask) ^ VP) | X;
            const uint64_t HN = VP & D0;
            const uint64_t HP = VN | (~(VP | D0) & mask);
            const uint64_t X2 = D0 >> 1;
            VN = X2 & HP;
            VP = (HN | (~(X2 | HP) & mask)) & mask;
            err += 1 - (int64_t)(D0 & 1);
            if (traceback) {
                st_vp[i + 1] = VP;
                st_d0[i + 1] = D0;
                st_hp[i + 1] = HP;
            }
            for (int c = 0; c < 4; ++c) peq[c] >>= 1;
            const int64_t nb = i + W;
            if (nb < pl) peq[yb[nb]] |= 1ULL << (W - 1);
        }
        // free-end scan over y endpoints tl .. min(tl+2e, pl)
        int64_t best_err = err, best_n = tl, e2 = err, e3 = err;
        const int64_t nb_max = (2 * e < pl - tl) ? 2 * e : (pl - tl);
        for (int64_t b0 = 0; b0 < 2 * e; ++b0) {
            e2 += (int64_t)((VP >> b0) & 1) - (int64_t)((VN >> b0) & 1);
            if (b0 < nb_max && e2 < best_err) { best_err = e2; best_n = tl + b0 + 1; }
            if (b0 < e) e3 = e3 + (int64_t)((VP >> b0) & 1) - (int64_t)((VN >> b0) & 1);
        }
        if (pl - tl >= e && e3 == best_err) best_n = tl + e;
        if (best_err > e) { err_out[b] = -1; ys_out[b] = -1; yn_out[b] = (int32_t)best_n; continue; }
        err_out[b] = (int32_t)best_err;
        yn_out[b] = (int32_t)best_n;
        if (!traceback) { ys_out[b] = -1; continue; }
        // bit-vector traceback
        int64_t i = tl, j = best_n;
        while (i > 0) {
            const int64_t bb = j - i;
            const uint64_t d0 = st_d0[i], hp = st_hp[i];
            bool diag_ok = false, horiz_ok = false, vert_ok = false;
            if (j >= 1 && bb >= 0 && bb <= 2 * e && j - 1 >= i - 1) {
                const bool match = (xb[i - 1] < 4) && (j - 1 < pl) &&
                                   (xb[i - 1] == yb[j - 1]);
                const bool d0bit = (d0 >> bb) & 1;
                diag_ok = (match && d0bit) || (!match && !d0bit);
            }
            if (j - 1 >= i && bb - 1 >= 0)
                horiz_ok = (st_vp[i] >> (bb - 1)) & 1;
            if (bb >= 0 && bb <= 2 * e && j <= (i - 1) + 2 * e)
                vert_ok = (hp >> bb) & 1;
            if (diag_ok) {
                tbp[i - 1] = yb[j - 1];
                --i; --j;
            } else if (horiz_ok) {
                if (icp[i - 1] < 255) ++icp[i - 1];
                ibp[i - 1] = yb[j - 1];
                --j;
            } else if (vert_ok) {
                tbp[i - 1] = 4;
                --i;
            } else {
#ifdef _OPENMP
#pragma omp atomic write
#endif
                stuck = b + 1;  // traceback stuck: impossible by invariant
                break;
            }
        }
        ys_out[b] = (int32_t)j;
    }
    }  // omp parallel
    return stuck ? -stuck : 0;
}

// ---------------------------------------------------------------------------
// Anchor-chain DP, one group at a time (scalar port of
// ops/chain.chain_scores_batch_np — identical scoring, incl. the integer
// Q16/Q4 fixed-point penalty, so results are bit-compatible with the
// numpy mirror AND the int32 TPU kernel; see ops/chain._pen_int_np).

#include <cmath>
#include <string>
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
// Zero-copy window-job alignment: windows are addressed into a flat
// sequence buffer (query slice = pointer; target window = bounds-checked
// virtual slice with sentinel padding), replicating WindowBatcher._run's
// semantics including the suffix-overlap tail clamp.

struct WinScratch {
    std::vector<uint64_t> vp, d0, hp;
    std::vector<uint8_t> ybuf;
    void init(int64_t XL, int64_t e, int traceback) {
        if (traceback) {
            vp.resize(XL + 1);
            d0.resize(XL + 1);
            hp.resize(XL + 1);
        }
        ybuf.resize(XL + 2 * e);
    }
};

// target accessor: logical position j of the (optionally
// reverse-complement) frame of a stored read
static inline uint8_t tgt_at(const uint8_t* t, int64_t tl_full, int rev,
                             int64_t j) {
    if (!rev) return t[j];
    const uint8_t c = t[tl_full - 1 - j];
    return c < 4 ? (uint8_t)(3 - c) : (uint8_t)4;
}

// Align ONE query window against a target slice. Writes the accepted
// traceback into tbp/icp/ibp (pre-initialised 5/0/0); returns err
// (-1 reject, -2 traceback stuck) and the in-band y range via *ys/*yn.
// *tl_out reports the effective (possibly tail-clamped) xlen so callers
// with UNinitialised arenas can fill [tl_out, xlen) themselves.
static int64_t win_align_one(
    const uint8_t* xb, int64_t xlen,
    const uint8_t* t, int64_t tl_full, int rev,
    int64_t t_ws, int is_last, int64_t e, int64_t acc_thre,
    int traceback, uint8_t* tbp, uint8_t* icp, uint8_t* ibp,
    WinScratch& S, int64_t* ys_out, int64_t* yn_out,
    int64_t* tl_out = nullptr) {
    const int W = int(2 * e + 1);
    const uint64_t mask = (W >= 64) ? ~0ULL : ((1ULL << W) - 1);
    const int64_t y0 = t_ws - e;
    int64_t tl = xlen;
    int64_t pl = tl + 2 * e;
    if (tl_full - y0 < pl) pl = tl_full - y0;
    if (pl < 0) pl = 0;
    if (is_last && pl < tl) tl = pl;   // suffix-overlap tail clamp
    if (tl_out) *tl_out = tl > 0 ? tl : 0;
    if (tl <= 0) { *ys_out = -1; *yn_out = 0; return -1; }
    // Exact fast path (the dominant case once reads are corrected, cf
    // the reference's exact-overlap counter in cal_ov_r, ecovlp.cpp:6385):
    // when x equals the target at shift 0, the DP below provably returns
    // (err=0, yn=tl+e, ys=e, all-diagonal traceback) — the final-row
    // scan can't beat 0 and the e3 == best_err override pins yn to tl+e
    // whenever pl - tl >= e — so a memcmp replaces the scan bit-
    // identically.
    if (pl - tl >= e && t_ws >= 0) {
        bool eq = true;
        if (!rev) {
            const uint8_t* yc = t + t_ws;
            for (int64_t i2 = 0; i2 < tl; ++i2)
                if (xb[i2] >= 4 || xb[i2] != yc[i2]) { eq = false; break; }
        } else {
            for (int64_t i2 = 0; i2 < tl; ++i2)
                if (xb[i2] >= 4 ||
                    xb[i2] != tgt_at(t, tl_full, 1, t_ws + i2)) {
                    eq = false;
                    break;
                }
        }
        if (eq) {
            *yn_out = tl + e;
            if (traceback) {
                std::memcpy(tbp, xb, (size_t)tl);
                *ys_out = e;
            } else {
                *ys_out = -1;
            }
            return 0;
        }
    }
    // materialise the virtually-padded target window once (small)
    for (int64_t j = 0; j < pl; ++j) {
        const int64_t p = y0 + j;
        S.ybuf[j] = (p >= 0 && p < tl_full) ? tgt_at(t, tl_full, rev, p)
                                            : (uint8_t)4;
    }
    const uint8_t* yb = S.ybuf.data();
    uint64_t peq[5] = {0, 0, 0, 0, 0};
    const int64_t w0 = W < pl ? W : pl;
    for (int64_t i = 0; i < w0; ++i) peq[yb[i]] |= 1ULL << i;
    uint64_t VP = 0, VN = 0;
    int64_t err = 0;
    for (int64_t i = 0; i < tl; ++i) {
        const uint64_t Eq = xb[i] < 4 ? peq[xb[i]] : 0;
        const uint64_t X = Eq | VN;
        const uint64_t D0 = (((VP + (X & VP)) & mask) ^ VP) | X;
        const uint64_t HN = VP & D0;
        const uint64_t HP = VN | (~(VP | D0) & mask);
        const uint64_t X2 = D0 >> 1;
        VN = X2 & HP;
        VP = (HN | (~(X2 | HP) & mask)) & mask;
        err += 1 - (int64_t)(D0 & 1);
        if (traceback) {
            S.vp[i + 1] = VP;
            S.d0[i + 1] = D0;
            S.hp[i + 1] = HP;
        }
        for (int c = 0; c < 4; ++c) peq[c] >>= 1;
        const int64_t nb = i + W;
        if (nb < pl) peq[yb[nb]] |= 1ULL << (W - 1);
    }
    int64_t best_err = err, best_n = tl, e2 = err, e3 = err;
    const int64_t nb_max = (2 * e < pl - tl) ? 2 * e : (pl - tl);
    for (int64_t b0 = 0; b0 < 2 * e; ++b0) {
        e2 += (int64_t)((VP >> b0) & 1) - (int64_t)((VN >> b0) & 1);
        if (b0 < nb_max && e2 < best_err) { best_err = e2; best_n = tl + b0 + 1; }
        if (b0 < e) e3 += (int64_t)((VP >> b0) & 1) - (int64_t)((VN >> b0) & 1);
    }
    if (pl - tl >= e && e3 == best_err) best_n = tl + e;
    if (best_err > e || best_err > acc_thre) {
        *ys_out = -1;
        *yn_out = best_n;
        return -1;
    }
    *yn_out = best_n;
    if (!traceback) { *ys_out = -1; return best_err; }
    int64_t i = tl, j = best_n;
    while (i > 0) {
        const int64_t bb = j - i;
        const uint64_t d0 = S.d0[i], hp = S.hp[i];
        bool diag_ok = false, horiz_ok = false, vert_ok = false;
        if (j >= 1 && bb >= 0 && bb <= 2 * e && j - 1 >= i - 1) {
            const bool match = (xb[i - 1] < 4) && (j - 1 < pl) &&
                               (xb[i - 1] == yb[j - 1]);
            const bool d0bit = (d0 >> bb) & 1;
            diag_ok = (match && d0bit) || (!match && !d0bit);
        }
        if (j - 1 >= i && bb - 1 >= 0)
            horiz_ok = (S.vp[i] >> (bb - 1)) & 1;
        if (bb >= 0 && bb <= 2 * e && j <= (i - 1) + 2 * e)
            vert_ok = (hp >> bb) & 1;
        if (diag_ok) { tbp[i - 1] = yb[j - 1]; --i; --j; }
        else if (horiz_ok) {
            if (icp[i - 1] < 255) ++icp[i - 1];
            ibp[i - 1] = yb[j - 1];
            --j;
        } else if (vert_ok) { tbp[i - 1] = 4; --i; }
        else { return -2; }
    }
    *ys_out = j;
    return best_err;
}

extern "C" int64_t ht_banded_jobs(
    int64_t n_jobs, int64_t XL, int64_t e,
    const uint8_t* flat,
    const int64_t* x_off, const int64_t* xlen_in,
    const int64_t* t_base, const int64_t* t_ws, const int64_t* t_len,
    const uint8_t* is_last,
    const int64_t* dst_base,   // arena offset per job (CSR destination)
    const int64_t* acc_thre,   // acceptance threshold per job
    int32_t* err_out, int32_t* ys_out, int32_t* yn_out,
    uint8_t* tb_arena, uint8_t* ic_arena, uint8_t* ib_arena,
    int32_t traceback) {
    int64_t stuck = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    WinScratch S;
    S.init(XL, e, traceback);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t b = 0; b < n_jobs; ++b) {
        int64_t ys = -1, yn = 0;
        const int64_t err = win_align_one(
            flat + x_off[b], xlen_in[b], flat + t_base[b], t_len[b], 0,
            t_ws[b], is_last[b], e, acc_thre[b], traceback,
            tb_arena + dst_base[b], ic_arena + dst_base[b],
            ib_arena + dst_base[b], S, &ys, &yn);
        if (err == -2) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
            stuck = b + 1;
            err_out[b] = -1;
        } else {
            err_out[b] = (int32_t)err;
        }
        ys_out[b] = (int32_t)ys;
        yn_out[b] = (int32_t)yn;
    }
    }  // omp parallel
    return stuck ? -stuck : 0;
}

// ---------------------------------------------------------------------------
// Fused per-batch EC stage: window planning + banded alignment + stats +
// phase + consensus in ONE call, OMP-parallel across reads (the TPU-host
// analog of the reference's per-read kt_for worker, worker_hap_ec
// ecovlp.cpp:3234 + gen_hc_r_alin_ea :2810). Targets are read straight
// from the 2-bit-decoded read bank; reverse-strand frames are computed
// on the fly (no per-(tid,rev) target materialisation). Tracebacks land
// in the shared CSR arena exactly as the unfused path writes them, and
// the same ec_read_one phase/consensus runs in-thread per read.

static int64_t ec_read_one(
    int64_t n_ov, const int64_t* off, const int64_t* x_s,
    const uint8_t* tb, const uint8_t* icnt, const uint8_t* ibase,
    const uint8_t* usable, int64_t qlen, const uint8_t* q,
    int64_t min_het_occ, int64_t occ_tot, double occ_exact,
    int32_t do_consensus, uint8_t* is_match, int64_t* n_het_out,
    uint8_t* out_seq, int64_t out_cap, int64_t* out_len,
    int64_t* n_edits_out, int64_t* ed_pos, int64_t* ed_delta,
    int64_t ed_cap, int64_t* ed_n);

#if defined(__AVX2__)
#include <immintrin.h>

// 4-lane SIMD Myers bit-vector DP over windows of IDENTICAL length tl
// (the dominant case: every non-tail EC window is exactly wl bases).
// Per-lane pl (target extent) may differ. Produces the same per-row
// traceback state as win_align_one, stored lane-interleaved.
struct WinScratch4 {
    std::vector<uint64_t> vp, d0, hp;   // rows lane-interleaved [i*4 + l]
    std::vector<uint8_t> ybuf;          // 4 lanes x ystride, 4-padded
    int64_t ystride = 0;
    void init(int64_t XL, int64_t e) {
        vp.resize((XL + 1) * 4);
        d0.resize((XL + 1) * 4);
        hp.resize((XL + 1) * 4);
        // the per-step Eq gather reads 64 bytes at yb + i (i < XL):
        // stride covers XL + 64 regardless of e; tail bytes are 4-filled
        // (code 4 matches nothing, so they contribute 0 bits)
        ystride = XL + 2 * e + 64;
        ybuf.resize(4 * ystride);
    }
};

// Band-match mask for one step: bit k = (y[k] == c), 64 positions.
static inline uint64_t eq_mask64(const uint8_t* y, uint8_t c) {
    const __m256i cv = _mm256_set1_epi8((char)c);
    const __m256i a = _mm256_loadu_si256((const __m256i*)y);
    const __m256i b = _mm256_loadu_si256((const __m256i*)(y + 32));
    const uint32_t m0 =
        (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, cv));
    const uint32_t m1 =
        (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(b, cv));
    return (uint64_t)m0 | ((uint64_t)m1 << 32);
}

static void win_dp_avx4(
    const uint8_t* const xb[4], int64_t tl,
    const uint8_t* const yb[4], const int64_t pl[4],
    int64_t e, WinScratch4& S,
    uint64_t VPf[4], uint64_t VNf[4], int64_t errf[4]) {
    (void)pl;    // positions >= pl are 4-filled in ybuf (never match)
    const int W = int(2 * e + 1);
    const uint64_t mask = (W >= 64) ? ~0ULL : ((1ULL << W) - 1);
    __m256i VP = _mm256_setzero_si256(), VN = _mm256_setzero_si256();
    __m256i errv = _mm256_setzero_si256();   // accumulates (D0 & 1)
    const __m256i maskv = _mm256_set1_epi64x((long long)mask);
    const __m256i ones = _mm256_set1_epi64x(1);
    for (int64_t i = 0; i < tl; ++i) {
        // Eq per lane: direct band compare (no peq state, no
        // loop-carried memory dependency); band at step i covers
        // y[i .. i+W).  Built with register inserts — a stack
        // round-trip here stalls on store-forwarding every step.
        const uint8_t c0 = xb[0][i], c1 = xb[1][i];
        const uint8_t c2 = xb[2][i], c3 = xb[3][i];
        const uint64_t e0 = c0 < 4 ? eq_mask64(yb[0] + i, c0) : 0;
        const uint64_t e1 = c1 < 4 ? eq_mask64(yb[1] + i, c1) : 0;
        const uint64_t e2 = c2 < 4 ? eq_mask64(yb[2] + i, c2) : 0;
        const uint64_t e3 = c3 < 4 ? eq_mask64(yb[3] + i, c3) : 0;
        const __m256i Eq = _mm256_and_si256(
            _mm256_set_epi64x((long long)e3, (long long)e2,
                              (long long)e1, (long long)e0), maskv);
        const __m256i X = _mm256_or_si256(Eq, VN);
        const __m256i XVP = _mm256_and_si256(X, VP);
        const __m256i sum = _mm256_add_epi64(VP, XVP);
        const __m256i D0 = _mm256_or_si256(
            _mm256_xor_si256(_mm256_and_si256(sum, maskv), VP), X);
        const __m256i HN = _mm256_and_si256(VP, D0);
        const __m256i HP = _mm256_or_si256(
            VN, _mm256_andnot_si256(_mm256_or_si256(VP, D0), maskv));
        const __m256i X2 = _mm256_srli_epi64(D0, 1);
        VN = _mm256_and_si256(X2, HP);
        VP = _mm256_and_si256(
            _mm256_or_si256(HN, _mm256_andnot_si256(
                _mm256_or_si256(X2, HP), maskv)), maskv);
        errv = _mm256_add_epi64(errv, _mm256_and_si256(D0, ones));
        _mm256_storeu_si256((__m256i*)&S.vp[(i + 1) * 4], VP);
        _mm256_storeu_si256((__m256i*)&S.d0[(i + 1) * 4], D0);
        _mm256_storeu_si256((__m256i*)&S.hp[(i + 1) * 4], HP);
    }
    alignas(32) uint64_t vpf[4], vnf[4], ef[4];
    _mm256_store_si256((__m256i*)vpf, VP);
    _mm256_store_si256((__m256i*)vnf, VN);
    _mm256_store_si256((__m256i*)ef, errv);
    for (int l = 0; l < 4; ++l) {
        VPf[l] = vpf[l];
        VNf[l] = vnf[l];
        errf[l] = tl - (int64_t)ef[l];
    }
}

// Ending-offset scan + traceback for one SIMD lane — the exact tail of
// win_align_one, reading the lane-interleaved row state.
static int64_t win_finish_lane(
    const uint8_t* xb, int64_t tl, const uint8_t* yb, int64_t pl,
    int64_t e, int64_t acc_thre, const WinScratch4& S, int lane,
    uint64_t VP, uint64_t VN, int64_t err,
    uint8_t* tbp, uint8_t* icp, uint8_t* ibp,
    int64_t* ys_out, int64_t* yn_out) {
    int64_t best_err = err, best_n = tl, e2 = err, e3 = err;
    const int64_t nb_max = (2 * e < pl - tl) ? 2 * e : (pl - tl);
    for (int64_t b0 = 0; b0 < 2 * e; ++b0) {
        e2 += (int64_t)((VP >> b0) & 1) - (int64_t)((VN >> b0) & 1);
        if (b0 < nb_max && e2 < best_err) {
            best_err = e2;
            best_n = tl + b0 + 1;
        }
        if (b0 < e)
            e3 += (int64_t)((VP >> b0) & 1) - (int64_t)((VN >> b0) & 1);
    }
    if (pl - tl >= e && e3 == best_err) best_n = tl + e;
    if (best_err > e || best_err > acc_thre) {
        *ys_out = -1;
        *yn_out = best_n;
        return -1;
    }
    *yn_out = best_n;
    int64_t i = tl, j = best_n;
    while (i > 0) {
        const int64_t bb = j - i;
        const uint64_t d0 = S.d0[i * 4 + lane], hp = S.hp[i * 4 + lane];
        bool diag_ok = false, horiz_ok = false, vert_ok = false;
        if (j >= 1 && bb >= 0 && bb <= 2 * e && j - 1 >= i - 1) {
            const bool match = (xb[i - 1] < 4) && (j - 1 < pl) &&
                               (xb[i - 1] == yb[j - 1]);
            const bool d0bit = (d0 >> bb) & 1;
            diag_ok = (match && d0bit) || (!match && !d0bit);
        }
        if (j - 1 >= i && bb - 1 >= 0)
            horiz_ok = (S.vp[i * 4 + lane] >> (bb - 1)) & 1;
        if (bb >= 0 && bb <= 2 * e && j <= (i - 1) + 2 * e)
            vert_ok = (hp >> bb) & 1;
        if (diag_ok) { tbp[i - 1] = yb[j - 1]; --i; --j; }
        else if (horiz_ok) {
            if (icp[i - 1] < 255) ++icp[i - 1];
            ibp[i - 1] = yb[j - 1];
            --j;
        } else if (vert_ok) { tbp[i - 1] = 4; --i; }
        else { return -2; }
    }
    *ys_out = j;
    return best_err;
}
#endif  // __AVX2__

// One planned window job inside ht_ec_batch (lane groups cross a
// read's overlaps; all queued jobs share tl == wl).
struct EcWinJob {
    const uint8_t* xb;
    const uint8_t* t;
    int64_t tl_full, t_ws, acc, dst, gw, o, tl;
    int rev;
};

extern "C" int64_t ht_ec_batch(
    int64_t R,
    const int64_t* q_off, const uint8_t* qcat,
    const int64_t* bank_off, const uint8_t* bank,
    const int64_t* r_ov_off,                    // [R+1] overlaps per read
    const int64_t* y_id, const uint8_t* rev_arr,
    const int64_t* x_s, const int64_t* x_e,     // [n_ov] query range (incl)
    const int64_t* hit_off, const int64_t* n_hits,
    const int64_t* hit_self, const int64_t* hit_t,
    const int64_t* arena_off,                   // [n_ov+1] global CSR
    uint8_t* tb_arena, uint8_t* ic_arena, uint8_t* ib_arena,
    int64_t wl, int64_t e, double e_rate, int64_t thre_cap,
    int64_t min_het_occ, int64_t occ_tot, double occ_exact,
    int32_t do_consensus,
    int32_t* win_tot, int32_t* win_ok, int64_t* err_sum,
    int64_t* ts_out, int64_t* te_out,           // [n_ov] target range
    uint8_t* is_match,                          // [n_ov]
    int64_t* n_het_out,                         // [R]
    uint8_t* out_seq, const int64_t* out_off,   // consensus CSR
    int64_t* out_len, int64_t* n_edits,
    int64_t* ed_pos, int64_t* ed_delta,         // [R*ed_stride] edit trace
    int64_t ed_stride, int64_t* ed_n) {         // [R]
    int64_t stuck = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    WinScratch S;
    S.init(wl, e, 1);
#if defined(__AVX2__)
    WinScratch4 S4;
    S4.init(wl, e);
#endif
    std::vector<uint8_t> usable;
    std::vector<int64_t> werr, wys, wyn, wtws, ov_w0;
    EcWinJob Q[5][4];
    int nq[5] = {0, 0, 0, 0, 0};

    // resolve one job's result bookkeeping (shared by both engines)
    auto settle = [&](const EcWinJob& jb, int64_t err, int64_t ys,
                      int64_t yn) {
        if (err < 0)
            std::memset(tb_arena + jb.dst, 5, (size_t)jb.tl);
        if (err == -2) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
            stuck = jb.o + 1;
            werr[jb.gw] = -2;
            return;
        }
        werr[jb.gw] = err;
        wys[jb.gw] = ys;
        wyn[jb.gw] = yn;
    };

    auto flush_cls = [&](int cls) {
        const int n = nq[cls];
        if (n == 0) return;
        EcWinJob* const Qc = Q[cls];
        const int64_t tl = Qc[0].tl;     // all group members share tl
#if defined(__AVX2__)
        // per-lane prep: clamp + exact fast path (same decisions as
        // win_align_one); survivors run the 4-lane DP
        const uint8_t* xbs[4];
        const uint8_t* ybs[4];
        int64_t pls[4];
        int real_j[4];
        int k = 0;
        for (int b = 0; b < n; ++b) {
            const EcWinJob& jb = Qc[b];
            const int64_t y0 = jb.t_ws - e;
            int64_t pl = tl + 2 * e;
            if (jb.tl_full - y0 < pl) pl = jb.tl_full - y0;
            if (pl < 0) pl = 0;
            // queued jobs are never is_last, so tl stays > 0
            if (pl - tl >= e && jb.t_ws >= 0) {
                bool eq = true;
                if (!jb.rev) {
                    const uint8_t* yc = jb.t + jb.t_ws;
                    for (int64_t i2 = 0; i2 < tl; ++i2)
                        if (jb.xb[i2] >= 4 || jb.xb[i2] != yc[i2]) {
                            eq = false;
                            break;
                        }
                } else {
                    for (int64_t i2 = 0; i2 < tl; ++i2)
                        if (jb.xb[i2] >= 4 ||
                            jb.xb[i2] !=
                                tgt_at(jb.t, jb.tl_full, 1,
                                       jb.t_ws + i2)) {
                            eq = false;
                            break;
                        }
                }
                if (eq) {
                    std::memcpy(tb_arena + jb.dst, jb.xb, (size_t)tl);
                    settle(jb, 0, e, tl + e);
                    continue;
                }
            }
            uint8_t* yb = S4.ybuf.data() + k * S4.ystride;
            std::memset(yb + pl, 4, (size_t)(S4.ystride - pl));
            for (int64_t j = 0; j < pl; ++j) {
                const int64_t p = y0 + j;
                yb[j] = (p >= 0 && p < jb.tl_full)
                            ? tgt_at(jb.t, jb.tl_full, jb.rev, p)
                            : (uint8_t)4;
            }
            xbs[k] = jb.xb;
            ybs[k] = yb;
            pls[k] = pl;
            real_j[k] = b;
            ++k;
        }
        if (k > 0) {
            for (int l = k; l < 4; ++l) {   // pad with lane-0 copies
                xbs[l] = xbs[0];
                ybs[l] = ybs[0];
                pls[l] = pls[0];
            }
            uint64_t VPf[4], VNf[4];
            int64_t errf[4];
            win_dp_avx4(xbs, tl, ybs, pls, e, S4, VPf, VNf, errf);
            for (int l = 0; l < k; ++l) {
                const EcWinJob& jb = Qc[real_j[l]];
                int64_t ys = -1, yn = 0;
                const int64_t err = win_finish_lane(
                    xbs[l], tl, ybs[l], pls[l], e, jb.acc, S4, l,
                    VPf[l], VNf[l], errf[l],
                    tb_arena + jb.dst, ic_arena + jb.dst,
                    ib_arena + jb.dst, &ys, &yn);
                settle(jb, err, ys, yn);
            }
        }
#else
        for (int b = 0; b < n; ++b) {
            const EcWinJob& jb = Qc[b];
            int64_t ys = -1, yn = 0, tl_eff = 0;
            const int64_t err = win_align_one(
                jb.xb, tl, jb.t, jb.tl_full, jb.rev, jb.t_ws, 0, e,
                jb.acc, 1, tb_arena + jb.dst, ic_arena + jb.dst,
                ib_arena + jb.dst, S, &ys, &yn, &tl_eff);
            settle(jb, err, ys, yn);
        }
#endif
        nq[cls] = 0;
    };
    auto flush = [&]() {
        for (int c = 0; c < 5; ++c) flush_cls(c);
    };

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 2)
#endif
    for (int64_t r = 0; r < R; ++r) {
        const int64_t o0 = r_ov_off[r], o1 = r_ov_off[r + 1];
        const uint8_t* q = qcat + q_off[r];
        const int64_t n_ov_r = o1 - o0;
        usable.assign(n_ov_r, 0);
        // flat per-read window bookkeeping so SIMD lane groups can
        // cross overlap boundaries
        ov_w0.assign(n_ov_r + 1, 0);
        // phased window grid (mirrors window_align._grid_phase): the
        // per-target phase de-correlates seam columns across voters
        const int64_t q5p = wl / 5;
        for (int64_t o = o0; o < o1; ++o) {
            const int64_t span = x_e[o] - x_s[o] + 1;
            int64_t ph = (q5p >= 64)
                ? (((int64_t)y_id[o] * 197 + rev_arr[o]) % 5) * q5p
                : 0;
            const int64_t P = ph ? ph : wl;
            const int64_t extra =
                span > P ? (span - P + wl - 1) / wl : 0;
            ov_w0[o - o0 + 1] = ov_w0[o - o0] + 1 + extra;
        }
        const int64_t nw_r = ov_w0[n_ov_r];
        werr.assign(nw_r, -1);
        wys.assign(nw_r, -1);
        wyn.assign(nw_r, 0);
        wtws.assign(nw_r, 0);
        for (int64_t o = o0; o < o1; ++o) {
            const int64_t tid = y_id[o];
            const int rev = rev_arr[o];
            const uint8_t* t = bank + bank_off[tid];
            const int64_t tl_full = bank_off[tid + 1] - bank_off[tid];
            const int64_t xs = x_s[o], xe = x_e[o];
            const int64_t nw = ov_w0[o - o0 + 1] - ov_w0[o - o0];
            win_tot[o] = (int32_t)nw;
            win_ok[o] = 0;
            err_sum[o] = 0;
            const int64_t hs0 = hit_off[o], hn = n_hits[o];
            int64_t hi = 0;
            const int64_t q5o = wl / 5;
            int64_t ph_o = (q5o >= 64)
                ? (((int64_t)y_id[o] * 197 + rev_arr[o]) % 5) * q5o
                : 0;
            const int64_t P_o = ph_o ? ph_o : wl;
            for (int64_t wi = 0; wi < nw; ++wi) {
                const int64_t gw = ov_w0[o - o0] + wi;
                const int64_t ws =
                    xs + (wi == 0 ? 0 : P_o + (wi - 1) * wl);
                const int64_t wend_g = xs + P_o + wi * wl;
                const int64_t wlen =
                    ((wend_g < xe + 1) ? wend_g : xe + 1) - ws;
                const int is_last = (ws + wlen > xe) ? 1 : 0;
                // nearest chain hit at-or-after the window start
                // (searchsorted-left semantics, clamped)
                while (hi < hn && hit_self[hs0 + hi] < ws) ++hi;
                const int64_t hc = hi < hn ? hi : hn - 1;
                const int64_t t_ws = hit_t[hs0 + hc] +
                                     (ws - hit_self[hs0 + hc]);
                int64_t thre = (int64_t)std::ceil((double)wlen * e_rate);
                if (thre < 2) thre = 2;
                if (thre > thre_cap) thre = thre_cap;
                int64_t acc = thre * 2 < thre_cap ? thre * 2 : thre_cap;
                const int64_t dst = arena_off[o] + (ws - xs);
                // arenas arrive UNinitialised: zero the insert tracks up
                // front (the traceback only writes insertion columns);
                // tb gets its 5-fill on reject/clamp
                std::memset(ic_arena + dst, 0, (size_t)wlen);
                std::memset(ib_arena + dst, 0, (size_t)wlen);
                wtws[gw] = t_ws;
                // SIMD-eligible: full windows (class 4) and the
                // QUANTIZED partial first windows (classes 0..3 by
                // length wl/5 multiple) — same-length lane groups
                // form across the read's overlaps
                const int64_t q5e = wl / 5;
                int cls_e = -1;
                if (!is_last) {
                    if (wlen == wl) cls_e = 4;
                    else if (q5e > 0 && wlen >= q5e && wlen < wl &&
                             wlen % q5e == 0 &&
                             wlen / q5e <= 4)
                        cls_e = (int)(wlen / q5e) - 1;
                }
                if (cls_e >= 0) {
                    EcWinJob& jb = Q[cls_e][nq[cls_e]];
                    jb.xb = q + ws;
                    jb.t = t;
                    jb.tl_full = tl_full;
                    jb.t_ws = t_ws;
                    jb.acc = acc;
                    jb.dst = dst;
                    jb.gw = gw;
                    jb.o = o;
                    jb.rev = rev;
                    jb.tl = wlen;
                    if (++nq[cls_e] == 4) flush_cls(cls_e);
                    continue;
                }
                int64_t ys = -1, yn = 0, tl_eff = 0;
                const int64_t err = win_align_one(
                    q + ws, wlen, t, tl_full, rev, t_ws, is_last, e, acc,
                    1, tb_arena + dst, ic_arena + dst, ib_arena + dst,
                    S, &ys, &yn, &tl_eff);
                if (err < 0)
                    std::memset(tb_arena + dst, 5, (size_t)wlen);
                else if (tl_eff < wlen)
                    std::memset(tb_arena + dst + tl_eff, 5,
                                (size_t)(wlen - tl_eff));
                if (err == -2) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
                    stuck = o + 1;
                    werr[gw] = -2;
                    continue;
                }
                werr[gw] = err;
                wys[gw] = ys;
                wyn[gw] = yn;
            }
        }
        flush();                      // drain the partial lane group
        // pass-1 snapshot: retry eligibility reads ONLY pass-1 results
        const std::vector<int64_t> werr0(werr);
        for (int64_t o = o0; o < o1; ++o) {
            const int64_t tid = y_id[o];
            const int rev = rev_arr[o];
            const uint8_t* t = bank + bank_off[tid];
            const int64_t tl_full = bank_off[tid + 1] - bank_off[tid];
            const int64_t xs = x_s[o], xe = x_e[o];
            const int64_t w0g = ov_w0[o - o0];
            const int64_t nw = ov_w0[o - o0 + 1] - w0g;
            // window-boundary retry (~recalcate_window_advance,
            // Correct.cpp:10935): a rejected window realigns at the
            // offset CHAINED from a pass-1-accepted neighbor — the
            // previous window's precise end (forward) or the next
            // window's precise start minus this window's length
            // (backward) — instead of the minimizer-hit projection that
            // missed.  The plan reads ONLY pass-1 results (one batched
            // retry round; keeps host/device engines bit-identical).
            const int64_t q5o2 = wl / 5;
            int64_t ph_o2 = (q5o2 >= 64)
                ? (((int64_t)y_id[o] * 197 + rev_arr[o]) % 5) * q5o2
                : 0;
            const int64_t P_o2 = ph_o2 ? ph_o2 : wl;
            for (int64_t wi = 0; wi < nw; ++wi) {
                const int64_t gw = w0g + wi;
                if (werr0[gw] != -1) continue;
                const int64_t ws =
                    xs + (wi == 0 ? 0 : P_o2 + (wi - 1) * wl);
                const int64_t wend_g = xs + P_o2 + wi * wl;
                const int64_t wlen =
                    ((wend_g < xe + 1) ? wend_g : xe + 1) - ws;
                int64_t t2 = -(int64_t)1 << 62;
                if (wi > 0 && werr0[gw - 1] >= 0) {
                    t2 = (wtws[gw - 1] - e) + wyn[gw - 1];
                } else if (wi + 1 < nw && werr0[gw + 1] >= 0 &&
                           wys[gw + 1] >= 0) {
                    t2 = (wtws[gw + 1] - e) + wys[gw + 1] - wlen;
                }
                if (t2 == (-(int64_t)1 << 62) || t2 == wtws[gw]) continue;
                const int is_last = (ws + wlen > xe) ? 1 : 0;
                int64_t thre = (int64_t)std::ceil((double)wlen * e_rate);
                if (thre < 2) thre = 2;
                if (thre > thre_cap) thre = thre_cap;
                int64_t acc = thre * 2 < thre_cap ? thre * 2 : thre_cap;
                const int64_t dst = arena_off[o] + (ws - xs);
                int64_t ys = -1, yn = 0, tl_eff = 0;
                std::memset(ic_arena + dst, 0, (size_t)wlen);
                std::memset(ib_arena + dst, 0, (size_t)wlen);
                const int64_t err = win_align_one(
                    q + ws, wlen, t, tl_full, rev, t2, is_last, e, acc,
                    1, tb_arena + dst, ic_arena + dst, ib_arena + dst,
                    S, &ys, &yn, &tl_eff);
                if (err < 0) {
                    std::memset(tb_arena + dst, 5, (size_t)wlen);
                    continue;
                }
                if (tl_eff < wlen)
                    std::memset(tb_arena + dst + tl_eff, 5,
                                (size_t)(wlen - tl_eff));
                werr[gw] = err;
                wys[gw] = ys;
                wyn[gw] = yn;
                wtws[gw] = t2;
            }
            // window-SEAM insertion evidence (mirrors WindowBatcher.
            // _inject_seams / the reference's round-2 repair pass): an
            // insertion straddling two windows is invisible to both
            // alignments; the skipped target bases appear as a gap
            // between consecutive accepted windows' target ranges.
            for (int64_t wi = 0; wi + 1 < nw; ++wi) {
                const int64_t gw = w0g + wi;
                if (werr[gw] < 0 || werr[gw + 1] < 0) continue;
                const int64_t ws =
                    xs + (wi == 0 ? 0 : P_o2 + (wi - 1) * wl);
                const int64_t wend_g = xs + P_o2 + wi * wl;
                const int64_t wlen =
                    ((wend_g < xe + 1) ? wend_g : xe + 1) - ws;
                if (wlen != wl) continue;          // grid-consecutive
                const int64_t lend = (wtws[gw] - e) + wyn[gw];
                const int64_t rstart = (wtws[gw + 1] - e) + wys[gw + 1];
                const int64_t gap = rstart - lend;
                if (gap < 1 || gap > 8) continue;
                uint8_t b0 = 0;
                bool same_b = true;
                for (int64_t gg = 0; gg < gap; ++gg) {
                    const int64_t tp = lend + gg;
                    if (tp < 0 || tp >= tl_full) { same_b = false; break; }
                    const uint8_t raw =
                        rev ? t[tl_full - 1 - tp] : t[tp];
                    if (raw > 3) { same_b = false; break; }
                    const uint8_t bb = rev ? (uint8_t)(3 - raw) : raw;
                    if (gg == 0) b0 = bb;
                    else if (bb != b0) { same_b = false; break; }
                }
                if (!same_b) continue;
                const int64_t col = arena_off[o] + (ws - xs) + wl - 1;
                if (ic_arena[col] == 0) {
                    ic_arena[col] = (uint8_t)(gap < 255 ? gap : 255);
                    ib_arena[col] = b0;
                } else if (ib_arena[col] == b0) {
                    const int64_t nc = (int64_t)ic_arena[col] + gap;
                    ic_arena[col] = (uint8_t)(nc < 255 ? nc : 255);
                }
            }
            int64_t first_ts = -1, last_te = -1;
            for (int64_t wi = 0; wi < nw; ++wi) {
                const int64_t gw = w0g + wi;
                if (werr[gw] < 0) continue;
                win_ok[o]++;
                err_sum[o] += werr[gw];
                const int64_t y0 = wtws[gw] - e;
                if (first_ts < 0)
                    first_ts = y0 + wys[gw] > 0 ? y0 + wys[gw] : 0;
                last_te = y0 + wyn[gw] - 1;
            }
            // precise target range from first/last accepted window;
            // chain-projected estimate when nothing aligned (the unfused
            // path keeps ov.y_s/y_e there — caller pre-fills ts/te)
            if (first_ts >= 0) {
                ts_out[o] = first_ts;
                te_out[o] = last_te;
            }
            // per-WINDOW evidence (~wcns_gen ecovlp.cpp:2293): any
            // aligned window lets the overlap vote; its unaligned
            // windows stay 5-filled and are skipped slot-by-slot
            usable[o - o0] = (win_ok[o] > 0);
        }
        const int64_t rc = ec_read_one(
            o1 - o0, arena_off + o0, x_s + o0,
            tb_arena, ic_arena, ib_arena, usable.data(),
            q_off[r + 1] - q_off[r], q,
            min_het_occ, occ_tot, occ_exact, do_consensus,
            is_match + o0, n_het_out + r, out_seq + out_off[r],
            out_off[r + 1] - out_off[r], out_len + r, n_edits + r,
            ed_pos + r * ed_stride, ed_delta + r * ed_stride,
            ed_stride, ed_n + r);
        if (rc != 0) out_len[r] = -1;
    }
    }  // omp parallel
    return stuck ? -stuck : 0;
}

// ---------------------------------------------------------------------------
// Per-read EC phasing + consensus (scalar port of ec/phase.py +
// ec/consensus.py; bit-compatible, cross-validated in tests):
// allele counts -> het sites -> cis/trans classification -> windowed
// majority consensus with het protection -> corrected sequence.

// Partial-order bundle walk over an insertion-vote map (mirrors
// ec/consensus.py _ins_bundle_walk bit-for-bit): emit the longest
// prefix every additional symbol of which keeps support above
// occ_exact * n — the Merge_DAGCon bundle merge (Correct.cpp:5031)
// for competing/nested insertion bundles.  Ties -> smallest symbol.
static void ins_bundle_walk(const std::map<std::string, int64_t>& m,
                            int64_t n, double occ_exact,
                            std::string& out) {
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
// plurality fails.
static bool star_msa_consensus(const std::vector<std::string>& strs,
                               const std::string& backbone,
                               double occ_exact, std::string& out) {
    const int64_t n = (int64_t)strs.size();
    const int64_t B = (int64_t)backbone.size();
    if (B == 0 || B > 64) return false;
    std::vector<std::array<int64_t, 5>> sub(
        (size_t)B, std::array<int64_t, 5>{0, 0, 0, 0, 0});
    std::vector<std::map<std::string, int64_t>> ins((size_t)B + 1);
    // backbone homopolymer runs for the deletion-bundle
    // canonicalization (mirrors ec/consensus.py bit-for-bit; the
    // same-base node merging of Merge_DAGCon, Correct.cpp:4700,4806)
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
        if ((int64_t)s.size() > 128) return false;
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
    // per-run eligibility + canonical kept length (mirrors the python
    // emission exactly: delete the k-th symbol only when the voters
    // emitting < k symbols clear the column-deletion occ threshold)
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

#if defined(__AVX2__)
// Byte-plane symbol histogram: planes[a][p0 + t] += (row[t] == a) for
// a < n_sym — the compare-subtract form turns the per-element scatter
// of the vote passes into contiguous vector adds (counts must fit
// uint8; callers guarantee n_ov + 2 < 250).
static void count_planes_avx2(const uint8_t* row, int64_t n,
                              uint8_t* planes, int64_t p0, int64_t qlen,
                              int n_sym) {
    int64_t t = 0;
    for (; t + 32 <= n; t += 32) {
        const __m256i v = _mm256_loadu_si256((const __m256i*)(row + t));
        for (int a = 0; a < n_sym; ++a) {
            uint8_t* dst = planes + (int64_t)a * qlen + p0 + t;
            const __m256i m =
                _mm256_cmpeq_epi8(v, _mm256_set1_epi8((char)a));
            const __m256i d = _mm256_loadu_si256((const __m256i*)dst);
            _mm256_storeu_si256((__m256i*)dst, _mm256_sub_epi8(d, m));
        }
    }
    for (; t < n; ++t) {
        const uint8_t c = row[t];
        if (c < n_sym) planes[(int64_t)c * qlen + p0 + t]++;
    }
}
#endif

static int64_t ec_read_one(
    int64_t n_ov, const int64_t* off, const int64_t* x_s,
    const uint8_t* tb, const uint8_t* icnt, const uint8_t* ibase,
    const uint8_t* usable,
    int64_t qlen, const uint8_t* q,
    int64_t min_het_occ, int64_t occ_tot, double occ_exact,
    int32_t do_consensus,
    uint8_t* is_match,        // [n_ov] out
    int64_t* n_het_out,       // [1] out
    uint8_t* out_seq,         // [out_cap] out (consensus)
    int64_t out_cap,
    int64_t* out_len,         // [1] out
    int64_t* n_edits_out,     // [1] out
    int64_t* ed_pos,          // [ed_cap] out: length-changing edit trace
    int64_t* ed_delta,        // [ed_cap] out (mirrors ConsensusResult.edits)
    int64_t ed_cap,
    int64_t* ed_n) {          // [1] out
    std::vector<int32_t> cnt4(qlen * 4, 0), cnt_del(qlen, 0);
    std::vector<uint8_t> het(qlen, 0), alt(qlen, 0);
#if defined(__AVX2__)
    const bool small_counts = (n_ov + 2) < 250;   // uint8 planes safe
    std::vector<uint8_t> plane;
#else
    const bool small_counts = false;
#endif
    // pass 1: allele counts over usable overlaps (substitution slots)
#if defined(__AVX2__)
    if (small_counts) {
        plane.assign((size_t)(5 * qlen), 0);
        for (int64_t o = 0; o < n_ov; ++o) {
            if (!usable[o]) { is_match[o] = 0; continue; }
            is_match[o] = 1;
            count_planes_avx2(tb + off[o], off[o + 1] - off[o],
                              plane.data(), x_s[o], qlen, 5);
        }
        for (int a = 0; a < 4; ++a) {
            const uint8_t* pl = plane.data() + (int64_t)a * qlen;
            for (int64_t p = 0; p < qlen; ++p)
                cnt4[p * 4 + a] = pl[p];
        }
        {
            const uint8_t* pl = plane.data() + (int64_t)4 * qlen;
            for (int64_t p = 0; p < qlen; ++p) cnt_del[p] = pl[p];
        }
    } else
#endif
    for (int64_t o = 0; o < n_ov; ++o) {
        if (!usable[o]) { is_match[o] = 0; continue; }
        is_match[o] = 1;
        const int64_t s = off[o], e = off[o + 1];
        const int64_t p0 = x_s[o];
        for (int64_t t = s; t < e; ++t) {
            const uint8_t v = tb[t];
            if (v <= 3) cnt4[(p0 + (t - s)) * 4 + v]++;
            else if (v == 4) cnt_del[p0 + (t - s)]++;
        }
    }
    int64_t n_het = 0;
    for (int64_t p = 0; p < qlen; ++p) {
        const int qa = q[p] <= 3 ? q[p] : 3;      // np.clip(q, 0, 3)
        cnt4[p * 4 + qa]++;                        // query's own vote
        const int32_t occ0 = cnt4[p * 4 + qa];
        int best_a = 0;
        int32_t best_c = -1;
        for (int a = 0; a < 4; ++a) {
            const int32_t c = (a == qa) ? 0 : cnt4[p * 4 + a];
            if (c > best_c) { best_c = c; best_a = a; }
        }
        alt[p] = (uint8_t)best_a;
        // two-sided balance test on top of the occ>=2 base rule
        // (~the SNP-matrix filter SetSnpMatrix/rphase_hc,
        // Correct.cpp:20191; mirrors ec/phase.py het_from_counts):
        // the minor allele must carry >= 25% of two-allele coverage,
        // else coincident errors / divergent repeat reads freeze the
        // site as het and invert the cis/trans split
        const int32_t minor = occ0 < best_c ? occ0 : best_c;
        // deletion-majority veto (mirrors het_from_counts): del votes
        // outnumbering every base vote mark an indel column, not a SNP
        const int64_t tot4 = (int64_t)cnt4[p * 4] + cnt4[p * 4 + 1] +
                             cnt4[p * 4 + 2] + cnt4[p * 4 + 3];
        if (occ0 >= min_het_occ && best_c >= min_het_occ && q[p] <= 3 &&
            (int64_t)minor * 4 >= (int64_t)occ0 + best_c &&
            !((int64_t)cnt_del[p] > tot4)) {
            het[p] = 1;
            ++n_het;
        }
    }
    // alignment-SHIFT veto (mirrors ec/phase.het_from_counts): an
    // uncorrected indel shifts the voters' columns by one, minting
    // adjacent pseudo-SNP pairs whose alt alleles are the query
    // shifted left/right by one — drop both sites of such pairs
    if (qlen >= 2 && n_het >= 2) {
        auto qcl = [&](int64_t p) -> int {
            return q[p] <= 3 ? q[p] : 3;
        };
        std::vector<uint8_t> drop((size_t)qlen, 0);
        for (int64_t p = 0; p + 1 < qlen; ++p) {
            if (!het[p] || !het[p + 1]) continue;
            const bool pl = p >= 1 && alt[p] == qcl(p - 1) &&
                            alt[p + 1] == qcl(p);
            const bool pr = p + 2 < qlen && alt[p] == qcl(p + 1) &&
                            alt[p + 1] == qcl(p + 2);
            if (pl || pr) drop[p] = drop[p + 1] = 1;
        }
        for (int64_t p = 0; p < qlen; ++p)
            if (drop[p] && het[p]) { het[p] = 0; --n_het; }
    }
    *n_het_out = n_het;
    // pass 2: per-overlap het agreement -> trans flips
    const int64_t min_flip = n_het >= 3 ? 1 : 2;
    if (n_het > 0) {
        for (int64_t o = 0; o < n_ov; ++o) {
            if (!usable[o]) continue;
            const int64_t s = off[o], e = off[o + 1];
            const int64_t p0 = x_s[o];
            int64_t n_same = 0, n_flip = 0;
            for (int64_t t = s; t < e; ++t) {
                const int64_t p = p0 + (t - s);
                if (!het[p]) continue;
                const uint8_t v = tb[t];
                if (v > 3) continue;
                const int qa = q[p] <= 3 ? q[p] : 3;
                if (v == qa) ++n_same;
                else if (v == alt[p]) ++n_flip;
            }
            if (n_flip > n_same && n_flip >= min_flip) is_match[o] = 2;
        }
    }
    *out_len = 0;
    *n_edits_out = 0;
    if (ed_n) *ed_n = 0;
    if (!do_consensus) return 0;
    // pass 3: cis-only votes (+ query) and insertion aggregates
    std::vector<int32_t> votes(qlen * 5, 0), ins_tot(qlen, 0),
        ins_bc(qlen * 4, 0), ins_lc(qlen * 9, 0);
#if defined(__AVX2__)
    if (small_counts) {
        plane.assign((size_t)(5 * qlen), 0);
        const __m256i zero = _mm256_setzero_si256();
        for (int64_t o = 0; o < n_ov; ++o) {
            if (is_match[o] != 1) continue;
            const int64_t s = off[o], e = off[o + 1];
            const int64_t p0 = x_s[o];
            count_planes_avx2(tb + s, e - s, plane.data(), p0, qlen, 5);
            // insertion events are sparse: SIMD-scan icnt for nonzero
            // bytes, handle hits scalar (only aligned slots count)
            int64_t t = s;
            for (; t + 32 <= e; t += 32) {
                const __m256i ic = _mm256_loadu_si256(
                    (const __m256i*)(icnt + t));
                uint32_t bits = (uint32_t)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(ic, zero)) ^ 0xFFFFFFFFu;
                while (bits) {
                    const int b = __builtin_ctz(bits);
                    bits &= bits - 1;
                    const int64_t tt = t + b;
                    const uint8_t v = tb[tt];
                    if (v > 4) continue;
                    const int64_t p = p0 + (tt - s);
                    ins_tot[p]++;
                    const int ib = ibase[tt] <= 3 ? ibase[tt] : 3;
                    ins_bc[p * 4 + ib]++;
                    const int il = icnt[tt] <= 8 ? icnt[tt] : 8;
                    ins_lc[p * 9 + il]++;
                }
            }
            for (; t < e; ++t) {
                if (icnt[t] == 0) continue;
                const uint8_t v = tb[t];
                if (v > 4) continue;
                const int64_t p = p0 + (t - s);
                ins_tot[p]++;
                const int ib = ibase[t] <= 3 ? ibase[t] : 3;
                ins_bc[p * 4 + ib]++;
                const int il = icnt[t] <= 8 ? icnt[t] : 8;
                ins_lc[p * 9 + il]++;
            }
        }
        for (int a = 0; a < 5; ++a) {
            const uint8_t* pl = plane.data() + (int64_t)a * qlen;
            for (int64_t p = 0; p < qlen; ++p)
                votes[p * 5 + a] = pl[p];
        }
    } else
#endif
    for (int64_t o = 0; o < n_ov; ++o) {
        if (is_match[o] != 1) continue;
        const int64_t s = off[o], e = off[o + 1];
        const int64_t p0 = x_s[o];
        for (int64_t t = s; t < e; ++t) {
            const uint8_t v = tb[t];
            if (v > 4) continue;
            const int64_t p = p0 + (t - s);
            votes[p * 5 + v]++;
            if (icnt[t] > 0) {
                ins_tot[p]++;
                const int ib = ibase[t] <= 3 ? ibase[t] : 3;
                ins_bc[p * 4 + ib]++;
                const int il = icnt[t] <= 8 ? icnt[t] : 8;
                ins_lc[p * 9 + il]++;
            }
        }
    }
    // finalize votes (query self-vote), per-column aggregates, ambiguity
    std::vector<int32_t> covv(qlen), wvv(qlen);
    std::vector<uint8_t> winv(qlen), amb(qlen, 0);
    for (int64_t p = 0; p < qlen; ++p) {
        const int qa = q[p] <= 3 ? q[p] : 3;
        votes[p * 5 + qa]++;                       // query's own vote
        int32_t cov = 0;
        int winner = 0;
        int32_t wv = -1;
        for (int a = 0; a < 5; ++a) {
            cov += votes[p * 5 + a];
            if (votes[p * 5 + a] > wv) { wv = votes[p * 5 + a]; winner = a; }
        }
        covv[p] = cov;
        wvv[p] = wv;
        winv[p] = (uint8_t)winner;
        // column ambiguity (mirrors ec/consensus.py _ambiguous_mask):
        // no majority symbol, or substantial-minority indel evidence
        // (a single real indel smeared across neighbouring columns)
        const int32_t dv = votes[p * 5 + 4];
        amb[p] = !het[p] && cov >= occ_tot &&
                 ((double)wv <= occ_exact * cov ||
                  ((double)dv > 0.25 * cov &&
                   (double)dv <= occ_exact * cov) ||
                  ((double)ins_tot[p] > 0.25 * cov &&
                   (double)ins_tot[p] <= occ_exact * cov));
    }
    // DAG cluster consensus (mirrors dag_cluster_consensus): group
    // ambiguous columns within 8 bp (>= 2 per cluster), extend +-2
    // context, then exact-string plurality among covering cis overlaps;
    // plurality failure falls back to the star-MSA realignment vote
    struct Repl { int64_t s, e; std::string r; };
    std::vector<Repl> repl;
    {
        std::vector<int64_t> pos;
        for (int64_t p = 0; p < qlen; ++p)
            if (amb[p]) pos.push_back(p);
        size_t gs = 0;
        for (size_t gi = 0; gi <= pos.size(); ++gi) {
            const bool brk = gi == pos.size() ||
                (gi > gs && pos[gi] - pos[gi - 1] > 8);
            if (!brk) continue;
            if (gi - gs >= 1) {
                int64_t cs = pos[gs] - 2 < 0 ? 0 : pos[gs] - 2;
                int64_t ce = pos[gi - 1] + 3 > qlen ? qlen : pos[gi - 1] + 3;
                // extend to homopolymer-run boundaries (capped),
                // mirroring dag_cluster_consensus: indel placement
                // within a run is alignment-ambiguous
                for (int64_t ext = 0;
                     cs > 0 && q[cs - 1] == q[cs] && ext < 12; ++ext)
                    --cs;
                for (int64_t ext = 0;
                     ce < qlen && q[ce] == q[ce - 1] && ext < 12; ++ext)
                    ++ce;
                bool has_het = false;
                for (int64_t p = cs; p < ce && !has_het; ++p)
                    has_het = het[p];
                if (!has_het) {
                    std::vector<std::string> strs;
                    for (int64_t o = 0; o < n_ov; ++o) {
                        if (is_match[o] != 1) continue;
                        const int64_t xs = x_s[o];
                        const int64_t n = off[o + 1] - off[o];
                        if (xs > cs || xs + n < ce) continue;
                        const int64_t lo = off[o] + (cs - xs);
                        bool bad = false;
                        std::string s8;
                        for (int64_t t = lo; t < lo + (ce - cs); ++t) {
                            const uint8_t v = tb[t];
                            if (v > 4) { bad = true; break; }
                            if (v <= 3) s8.push_back((char)v);
                            if (icnt[t] > 0) {
                                const char b =
                                    (char)(ibase[t] <= 3 ? ibase[t] : 3);
                                const int c = icnt[t] <= 8 ? icnt[t] : 8;
                                s8.append(c, b);
                            }
                        }
                        if (!bad) strs.push_back(std::move(s8));
                    }
                    std::string qs;
                    for (int64_t p = cs; p < ce; ++p)
                        qs.push_back((char)(q[p] <= 3 ? q[p] : 3));
                    strs.push_back(qs);
                    const int64_t n_voters = (int64_t)strs.size();
                    std::sort(strs.begin(), strs.end());
                    size_t bi = 0, bc = 0;
                    for (size_t i = 0; i < strs.size();) {
                        size_t j = i;
                        while (j < strs.size() && strs[j] == strs[i]) ++j;
                        if (j - i > bc) { bc = j - i; bi = i; }
                        i = j;
                    }
                    if (n_voters >= occ_tot) {
                        if ((double)bc > occ_exact * n_voters) {
                            if (strs[bi] != qs)
                                repl.push_back({cs, ce, strs[bi]});
                        } else {
                            // plurality failed: realign voters onto the
                            // plurality backbone and vote column-wise
                            std::string cons;
                            if (star_msa_consensus(strs, strs[bi],
                                                   occ_exact, cons) &&
                                !cons.empty() && cons != qs)
                                repl.push_back({cs, ce, cons});
                        }
                    }
                }
            }
            gs = gi;
        }
    }
    // thin-coverage corner rescue pre-pass (mirrors consensus_decide):
    // one aligned voter corrects (the reference's DAG threshold counts
    // only overlap edges, Correct.cpp:5579), gated so at most 2 rescue
    // events fall in any +-8 bp neighbourhood (a misaligned lone voter
    // disagrees in bursts; a genuine one at isolated columns)
    std::vector<uint8_t> thin_sub(qlen, 0), thin_ins_v(qlen, 0),
        thin_win(qlen, 0);
    {
        for (int64_t p = 0; p < qlen; ++p) {
            if (covv[p] != 2 || het[p]) continue;
            const int qa = q[p] <= 3 ? q[p] : 3;
            int v_win = 0;
            int32_t v_tot = 0, v_max = -1;
            for (int a = 0; a < 5; ++a) {
                const int32_t c = votes[p * 5 + a] - (a == qa ? 1 : 0);
                v_tot += c;
                if (c > v_max) { v_max = c; v_win = a; }
            }
            if (v_tot == 1 && v_win != qa) {
                thin_sub[p] = 1;
                thin_win[p] = (uint8_t)v_win;
            }
            if (ins_tot[p] == 1) thin_ins_v[p] = 1;
        }
        std::vector<int64_t> cs(qlen + 1, 0);
        for (int64_t p = 0; p < qlen; ++p)
            cs[p + 1] = cs[p] + (thin_sub[p] || thin_ins_v[p] ? 1 : 0);
        for (int64_t p = 0; p < qlen; ++p) {
            const int64_t lo = p - 8 < 0 ? 0 : p - 8;
            const int64_t hi = p + 9 > qlen ? qlen : p + 9;
            if (cs[hi] - cs[lo] > 2) thin_sub[p] = thin_ins_v[p] = 0;
        }
    }
    int64_t w_out = 0, n_edits = 0, n_ed = 0;
    // emit a length-changing edit event (pos, delta); cap overflow falls
    // back to the python path (which computes the same trace)
    auto emit_ed = [&](int64_t pos, int64_t delta) -> bool {
        if (!ed_pos) return true;
        if (n_ed >= ed_cap) return false;
        ed_pos[n_ed] = pos;
        ed_delta[n_ed] = delta;
        ++n_ed;
        return true;
    };
    size_t ri = 0;
    for (int64_t p = 0; p < qlen; ++p) {
        if (ri < repl.size() && p == repl[ri].s) {
            const Repl& R = repl[ri++];
            if (w_out + (int64_t)R.r.size() + 4 >= out_cap) return -1;
            if ((int64_t)R.r.size() != R.e - R.s &&
                !emit_ed(R.e, (int64_t)R.r.size() - (R.e - R.s)))
                return -1;
            for (char c : R.r) out_seq[w_out++] = (uint8_t)c;
            // Levenshtein edit count on the tiny cluster range
            {
                const int64_t la = R.e - R.s, lb = (int64_t)R.r.size();
                std::vector<int64_t> prev(lb + 1), cur(lb + 1);
                for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
                for (int64_t i = 1; i <= la; ++i) {
                    cur[0] = i;
                    const uint8_t qa2 =
                        q[R.s + i - 1] <= 3 ? q[R.s + i - 1] : 3;
                    for (int64_t j = 1; j <= lb; ++j) {
                        const int64_t sub =
                            prev[j - 1] + ((uint8_t)R.r[j - 1] != qa2);
                        const int64_t del = prev[j] + 1, ins = cur[j - 1] + 1;
                        cur[j] = sub < del ? (sub < ins ? sub : ins)
                                           : (del < ins ? del : ins);
                    }
                    std::swap(prev, cur);
                }
                n_edits += prev[lb];
            }
            p = R.e - 1;                           // skip the cluster range
            continue;
        }
        const int qa = q[p] <= 3 ? q[p] : 3;
        const int32_t cov = covv[p];
        const int32_t wv = wvv[p];
        int winner = winv[p];
        bool pass_sub = cov >= occ_tot && (double)wv > occ_exact * cov &&
                        winner != qa && !het[p];
        if (thin_sub[p]) {
            pass_sub = true;
            winner = thin_win[p];
        }
        bool pass_ins = (cov >= occ_tot &&
                         (double)ins_tot[p] > occ_exact * cov &&
                         !het[p]) ||
                        thin_ins_v[p];
        if (w_out + 10 >= out_cap) return -1;      // caller falls back
        if (pass_sub) {
            if (winner != 4) out_seq[w_out++] = (uint8_t)winner;
            else if (!emit_ed(p + 1, -1)) return -1;
            ++n_edits;
        } else {
            out_seq[w_out++] = q[p];
        }
        if (pass_ins) {
            int best_b = 0;
            int32_t bc = -1;
            for (int a = 0; a < 4; ++a)
                if (ins_bc[p * 4 + a] > bc) { bc = ins_bc[p * 4 + a]; best_b = a; }
            int best_l = 1;
            int32_t lc = -1;
            for (int l = 1; l <= 8; ++l)
                if (ins_lc[p * 9 + l] > lc) { lc = ins_lc[p * 9 + l]; best_l = l; }
            if (w_out + best_l + 4 >= out_cap) return -1;
            if (!emit_ed(p + 1, best_l)) return -1;
            for (int t = 0; t < best_l; ++t)
                out_seq[w_out++] = (uint8_t)best_b;
            n_edits += best_l;
        }
    }
    *out_len = w_out;
    *n_edits_out = n_edits;
    if (ed_n) *ed_n = n_ed;
    return 0;
}

extern "C" int64_t ht_ec_read(
    int64_t n_ov, const int64_t* off, const int64_t* x_s,
    const uint8_t* tb, const uint8_t* icnt, const uint8_t* ibase,
    const uint8_t* usable,
    int64_t qlen, const uint8_t* q,
    int64_t min_het_occ, int64_t occ_tot, double occ_exact,
    int32_t do_consensus,
    uint8_t* is_match, int64_t* n_het_out,
    uint8_t* out_seq, int64_t out_cap,
    int64_t* out_len, int64_t* n_edits_out,
    int64_t* ed_pos, int64_t* ed_delta, int64_t ed_cap, int64_t* ed_n) {
    return ec_read_one(n_ov, off, x_s, tb, icnt, ibase, usable, qlen, q,
                       min_het_occ, occ_tot, occ_exact, do_consensus,
                       is_match, n_het_out, out_seq, out_cap, out_len,
                       n_edits_out, ed_pos, ed_delta, ed_cap, ed_n);
}

// Batched phase+consensus over a flush's worth of reads in one call,
// OMP-parallel across reads. Per-read CSR slices address the SHARED
// traceback arena (absolute offsets); out_len[r] = -1 flags a per-read
// consensus-buffer overflow (caller falls back to the python path).
extern "C" void ht_ec_reads(
    int64_t R,
    const int64_t* r_ov_off,   // [R+1] per-read overlap ranges
    const int64_t* off_idx,    // [R] start of read r's slice in off_cat
    const int64_t* off_cat,    // per-read absolute CSR (incl. sentinels)
    const int64_t* x_s,        // [sum n_ov]
    const uint8_t* tb, const uint8_t* icnt, const uint8_t* ibase,
    const uint8_t* usable,     // [sum n_ov]
    const int64_t* q_off,      // [R+1] into flat q
    const uint8_t* q,
    int64_t min_het_occ, int64_t occ_tot, double occ_exact,
    int32_t do_consensus,
    uint8_t* is_match,         // [sum n_ov]
    int64_t* n_het_out,        // [R]
    uint8_t* out_seq,          // [out_off[R]]
    const int64_t* out_off,    // [R+1] per-read consensus capacity CSR
    int64_t* out_len,          // [R]
    int64_t* n_edits_out,      // [R]
    int64_t* ed_pos, int64_t* ed_delta,  // [R*ed_stride] edit trace
    int64_t ed_stride, int64_t* ed_n) {  // [R]
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
    for (int64_t r = 0; r < R; ++r) {
        const int64_t ro = r_ov_off[r];
        const int64_t rc = ec_read_one(
            r_ov_off[r + 1] - ro, off_cat + off_idx[r], x_s + ro,
            tb, icnt, ibase, usable + ro,
            q_off[r + 1] - q_off[r], q + q_off[r],
            min_het_occ, occ_tot, occ_exact, do_consensus,
            is_match + ro, n_het_out + r, out_seq + out_off[r],
            out_off[r + 1] - out_off[r], out_len + r, n_edits_out + r,
            ed_pos + r * ed_stride, ed_delta + r * ed_stride,
            ed_stride, ed_n + r);
        if (rc != 0) out_len[r] = -1;
    }
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
