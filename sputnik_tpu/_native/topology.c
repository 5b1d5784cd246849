/* Native topology builder — host-side runtime core.
 *
 * The reference's native layer is CUDA binding code (src/sputnik.cpp,
 * src/spmm_cuda.cu); here the device side is Pallas, so the native
 * runtime work moves to the HOST: building CSR structure, transpose
 * permutations and block-panel metadata for big topologies (a 4096^2
 * mask is 16.7M entries — pure-numpy paths cost seconds at model build
 * / per-step mask refresh; these are linear-time C single passes).
 *
 * Compiled on demand (cc -O3 -shared -fPIC) and loaded via ctypes —
 * no pybind11 dependency. numpy fallbacks remain in topology.py /
 * blocking.py; results are bit-identical (tests assert this).
 */

#include <stdint.h>
#include <string.h>

/* Count nonzeros of a float32 matrix. */
int64_t count_nnz_f32(const float *mat, int64_t mn) {
    int64_t nnz = 0;
    for (int64_t i = 0; i < mn; ++i) nnz += (mat[i] != 0.0f);
    return nnz;
}

/* Dense float32 [m, n] -> CSR (row_offsets i32[m+1], col_indices i32[nnz],
 * values f32[nnz]). Returns nnz. Buffers must be pre-sized. */
int64_t csr_from_dense_f32(const float *mat, int32_t m, int32_t n,
                           int32_t *row_offsets, int32_t *col_indices,
                           float *values) {
    int64_t k = 0;
    row_offsets[0] = 0;
    for (int32_t r = 0; r < m; ++r) {
        const float *row = mat + (int64_t)r * n;
        for (int32_t c = 0; c < n; ++c) {
            if (row[c] != 0.0f) {
                col_indices[k] = c;
                values[k] = row[c];
                ++k;
            }
        }
        row_offsets[r + 1] = (int32_t)k;
    }
    return k;
}

/* CSR -> CSC permutation via counting sort: O(nnz + n).
 * rows/cols: COO arrays of the source (CSR order).
 * Outputs: ro_t i32[n+1], ci_t i32[nnz], perm i32[nnz] with
 * values_t = values[perm] (stable within a column, by row). */
void transpose_perm(const int32_t *rows, const int32_t *cols, int64_t nnz,
                    int32_t n, int32_t *ro_t, int32_t *ci_t, int32_t *perm) {
    memset(ro_t, 0, (size_t)(n + 1) * sizeof(int32_t));
    for (int64_t e = 0; e < nnz; ++e) ro_t[cols[e] + 1]++;
    for (int32_t c = 0; c < n; ++c) ro_t[c + 1] += ro_t[c];
    /* stable fill: CSR order is row-major, so walking e ascending keeps
     * rows sorted within each column. Use a scratch cursor in ci_t? No —
     * need separate cursors; reuse a local allocation-free trick: shift
     * offsets as cursors, then restore. */
    for (int64_t e = 0; e < nnz; ++e) {
        int32_t c = cols[e];
        int32_t slot = ro_t[c]++;
        ci_t[slot] = rows[e];
        perm[slot] = (int32_t)e;
    }
    /* restore offsets (they have each advanced by their count) */
    for (int32_t c = n; c > 0; --c) ro_t[c] = ro_t[c - 1];
    ro_t[0] = 0;
}

/* Block-panel metadata: one linear pass + per-row-block column marker.
 * Inputs: COO rows/cols (CSR order), tile sizes bm x bk, grid mb x kb.
 * Outputs:
 *   nblocks    i32[mb]           occupied blocks per row-block
 *   block_cols i32[mb * max_bpr] (padded with last valid col) — PASS 2
 *   slot_of    i32[mb * kb]      colblock -> slot map (scratch, caller-alloc)
 *   scatter    i32[nnz]          element -> flat panel index
 * Two-call protocol: pass 1 (block_cols == NULL) fills nblocks and returns
 * max blocks-per-row-block; pass 2 fills block_cols/scatter using max_bpr. */
int32_t block_build(const int32_t *rows, const int32_t *cols, int64_t nnz,
                    int32_t bm, int32_t bk, int32_t mb, int32_t kb,
                    int32_t max_bpr, int32_t *nblocks, int32_t *block_cols,
                    int32_t *slot_of, int32_t *scatter) {
    if (block_cols == NULL) {
        /* pass 1: count distinct column-blocks per row-block */
        memset(nblocks, 0, (size_t)mb * sizeof(int32_t));
        for (int64_t i = 0; i < (int64_t)mb * kb; ++i) slot_of[i] = -1;
        for (int64_t e = 0; e < nnz; ++e) {
            int32_t rb = rows[e] / bm, cb = cols[e] / bk;
            int64_t key = (int64_t)rb * kb + cb;
            if (slot_of[key] < 0) slot_of[key] = nblocks[rb]++;
        }
        int32_t mx = 1;
        for (int32_t i = 0; i < mb; ++i)
            if (nblocks[i] > mx) mx = nblocks[i];
        return mx;
    }
    /* pass 2: emit block_cols (sorted by column within a row-block, which
     * CSR order does NOT guarantee across rows — rebuild slots in column
     * order for determinism with the numpy np.unique path) */
    for (int64_t i = 0; i < (int64_t)mb * kb; ++i) slot_of[i] = -1;
    memset(nblocks, 0, (size_t)mb * sizeof(int32_t));
    /* mark occupied (rb, cb) */
    for (int64_t e = 0; e < nnz; ++e) {
        int32_t rb = rows[e] / bm, cb = cols[e] / bk;
        slot_of[(int64_t)rb * kb + cb] = 1;
    }
    /* assign slots in ascending column order per row-block */
    for (int32_t rb = 0; rb < mb; ++rb) {
        int32_t s = 0;
        for (int32_t cb = 0; cb < kb; ++cb) {
            int64_t key = (int64_t)rb * kb + cb;
            if (slot_of[key] > 0) {
                slot_of[key] = s;
                block_cols[(int64_t)rb * max_bpr + s] = cb;
                ++s;
            } else {
                slot_of[key] = -1;
            }
        }
        nblocks[rb] = s;
        for (int32_t p = s; p < max_bpr; ++p)
            block_cols[(int64_t)rb * max_bpr + p] =
                s > 0 ? block_cols[(int64_t)rb * max_bpr + s - 1] : 0;
    }
    /* scatter index per element */
    for (int64_t e = 0; e < nnz; ++e) {
        int32_t rb = rows[e] / bm, cb = cols[e] / bk;
        int32_t s = slot_of[(int64_t)rb * kb + cb];
        int32_t r_in = rows[e] % bm, c_in = cols[e] % bk;
        scatter[e] = (int32_t)((((int64_t)rb * max_bpr + s) * bm + r_in) * bk
                               + c_in);
    }
    return max_bpr;
}

/* Expanded COO row ids from offsets: row_ids[e] = r for e in [ro[r], ro[r+1]) */
void expand_row_ids(const int32_t *row_offsets, int32_t m, int32_t *row_ids) {
    for (int32_t r = 0; r < m; ++r)
        for (int32_t e = row_offsets[r]; e < row_offsets[r + 1]; ++e)
            row_ids[e] = r;
}
