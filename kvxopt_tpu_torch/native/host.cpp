// Host-side sparse kernels for kvxopt_tpu_torch (a copy of
// kvxopt_tpu/native/host.cpp).
//
// Native equivalents (written from scratch) of the capabilities the
// reference gets from SuiteSparse:
//   - minimum-degree fill-reducing ordering      (reference: src/C/amd.c)
//   - elimination tree symbolic analysis         (reference: cholmod.c symbolic)
//   - simplicial numeric Cholesky LDL'           (reference: cholmod.c numeric)
//   - left-looking sparse LU with partial pivoting, symbolic reuse and
//     fast numeric refactorization               (reference: klu.c:234-302,
//                                                 umfpack.c:232-292)
//   - triangular solves, determinants            (klu.c:693, umfpack.c:671)
//
// All matrices are compressed-sparse-column (CSC) with 64-bit indices,
// matching the reference's ccs struct (src/C/kvxopt.h:58-69).  Exposed via
// a plain C ABI consumed through ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

using i64 = long long;
using cplx = std::complex<double>;

static inline double mag(double v) { return std::fabs(v); }
static inline double mag(const cplx& v) { return std::abs(v); }
static inline double conj_of(double v) { return v; }
static inline cplx conj_of(const cplx& v) { return std::conj(v); }

// ---------------------------------------------------------------------------
// Approximate minimum degree (AMD) ordering: quotient graph with element
// absorption, Amestoy/Davis/Duff approximate external degrees, aggressive
// element absorption, and supervariable (twin) merging.  Written from
// scratch against the published algorithm; the reference links SuiteSparse
// AMD (src/C/amd.c).  A must be structurally symmetric (pattern of A+A').
// ---------------------------------------------------------------------------
static void amd_order_impl(i64 n, const i64* colptr, const i64* rowind,
                           i64* perm) {
  // quotient graph: per-variable lists A (variables) and E (elements);
  // per-element list L (variables).  Eliminated pivots become elements
  // reusing their own index.
  std::vector<std::vector<i64>> A(n), E(n), L(n);
  std::vector<i64> nv(n, 1);       // supervariable mass; 0 = absorbed
  std::vector<i64> degree(n);      // approximate external degree
  std::vector<i64> elsize(n, 0);   // |L_e| in nv units for live elements
  std::vector<char> eliminated(n, 0), dead_elem(n, 0);
  std::vector<i64> parent(n, -1);  // supervariable absorption parent
  std::vector<i64> mark(n, -1), wtag(n, -1), wcnt(n, 0);

  for (i64 j = 0; j < n; ++j) {
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      if (i != j) A[j].push_back(i);
    }
    std::sort(A[j].begin(), A[j].end());
    A[j].erase(std::unique(A[j].begin(), A[j].end()), A[j].end());
    degree[j] = (i64)A[j].size();
  }

  // degree buckets with lazy deletion
  std::vector<std::vector<i64>> bucket(n + 1);
  for (i64 j = 0; j < n; ++j) bucket[degree[j]].push_back(j);
  i64 cur = 0;
  auto push_bucket = [&](i64 v) {
    i64 d = degree[v];
    if (d < 0) d = 0;
    if (d > n) d = n;
    bucket[d].push_back(v);
    if (d < cur) cur = d;
  };

  std::vector<i64> elim_order;
  elim_order.reserve(n);
  std::vector<i64> Lme;
  i64 tag = 0;
  i64 k = 0;
  while (k < n) {
    // --- pivot: live principal variable of minimum approximate degree
    i64 me = -1;
    while (me < 0) {
      while (cur <= n && bucket[cur].empty()) cur++;
      i64 cand = bucket[cur].back();
      bucket[cur].pop_back();
      if (eliminated[cand] || nv[cand] <= 0) continue;
      i64 d = degree[cand];
      if (d < 0) d = 0;
      if (d > n) d = n;
      if (d == cur) me = cand;  // else: stale entry, re-pushed elsewhere
    }

    // --- form Lme = (A_me ∪ U_{e in E_me} L_e) minus dead minus {me}
    ++tag;
    Lme.clear();
    mark[me] = tag;
    i64 degme = 0;
    for (i64 i : A[me]) {
      if (nv[i] <= 0 || eliminated[i]) continue;
      if (mark[i] != tag) {
        mark[i] = tag;
        Lme.push_back(i);
        degme += nv[i];
      }
    }
    for (i64 e : E[me]) {
      if (dead_elem[e]) continue;
      for (i64 i : L[e]) {
        if (nv[i] <= 0 || eliminated[i]) continue;
        if (mark[i] != tag) {
          mark[i] = tag;
          Lme.push_back(i);
          degme += nv[i];
        }
      }
      dead_elem[e] = 1;  // absorbed into the new element me
      L[e].clear();
      L[e].shrink_to_fit();
    }
    A[me].clear();
    A[me].shrink_to_fit();
    E[me].clear();
    E[me].shrink_to_fit();
    eliminated[me] = 1;
    elim_order.push_back(me);
    k += nv[me];
    L[me] = Lme;
    elsize[me] = degme;

    // --- |L_e \ Lme| for every element adjacent to Lme (the AMD w trick)
    for (i64 i : Lme) {
      for (i64 e : E[i]) {
        if (dead_elem[e]) continue;
        if (wtag[e] != tag) {
          wtag[e] = tag;
          wcnt[e] = elsize[e];
        }
        wcnt[e] -= nv[i];
      }
    }

    // --- degree update + list pruning + aggressive absorption
    for (i64 i : Lme) {
      i64 d_elems = 0;
      size_t out = 0;
      for (i64 e : E[i]) {
        if (dead_elem[e]) continue;
        i64 ext = (wtag[e] == tag) ? wcnt[e] : elsize[e];
        if (ext <= 0) {
          // aggressive absorption: L_e subset of Lme ∪ {me}
          dead_elem[e] = 1;
          L[e].clear();
          L[e].shrink_to_fit();
          continue;
        }
        d_elems += ext;
        E[i][out++] = e;
      }
      E[i].resize(out);
      i64 d_vars = 0;
      out = 0;
      for (i64 v : A[i]) {
        if (nv[v] <= 0 || eliminated[v]) continue;
        if (mark[v] == tag) continue;  // covered by the new element me
        d_vars += nv[v];
        A[i][out++] = v;
      }
      A[i].resize(out);
      E[i].push_back(me);
      i64 dext = degme - nv[i];            // |Lme \ i|
      i64 cap = n - k - nv[i];             // all other live variables
      i64 dnew = std::min(std::min(degree[i] + dext, cap),
                          d_vars + dext + d_elems);
      degree[i] = dnew < 0 ? 0 : dnew;
    }

    // --- supervariable (twin) detection among Lme members
    std::unordered_map<unsigned long long, std::vector<i64>> hb;
    hb.reserve(Lme.size() * 2);
    for (i64 i : Lme) {
      if (nv[i] <= 0) continue;
      unsigned long long h =
          1469598103934665603ull ^ (unsigned long long)A[i].size();
      for (i64 v : A[i]) h += (unsigned long long)v * 2654435761ull;
      for (i64 e : E[i]) h += (unsigned long long)e * 40503ull;
      hb[h].push_back(i);
    }
    for (auto& kv : hb) {
      auto& cands = kv.second;
      if (cands.size() < 2) continue;
      for (size_t a = 0; a < cands.size(); ++a) {
        i64 i = cands[a];
        if (nv[i] <= 0) continue;
        for (size_t b = a + 1; b < cands.size(); ++b) {
          i64 j = cands[b];
          if (nv[j] <= 0) continue;
          if (E[i].size() != E[j].size() || A[i].size() != A[j].size())
            continue;
          // twins iff E_i == E_j and A_i \ {j} == A_j \ {i} (live sets)
          ++tag;
          bool twin = true;
          for (i64 e : E[i]) mark[e] = tag;
          for (i64 e : E[j])
            if (mark[e] != tag) { twin = false; break; }
          if (twin) {
            ++tag;
            i64 live_i = 0;
            for (i64 v : A[i])
              if (v != j && nv[v] > 0 && !eliminated[v]) {
                mark[v] = tag;
                live_i++;
              }
            i64 live_j = 0;
            for (i64 v : A[j]) {
              if (v == i || nv[v] <= 0 || eliminated[v]) continue;
              if (mark[v] != tag) { twin = false; break; }
              live_j++;
            }
            if (twin && live_i != live_j) twin = false;
          }
          if (twin) {
            degree[i] -= nv[j];
            if (degree[i] < 0) degree[i] = 0;
            nv[i] += nv[j];
            nv[j] = 0;
            parent[j] = i;
            E[j].clear();
            E[j].shrink_to_fit();
            A[j].clear();
            A[j].shrink_to_fit();
          }
        }
      }
    }

    for (i64 i : Lme)
      if (nv[i] > 0) push_bucket(i);
  }

  // --- output: pivots in elimination order, each followed by the
  // variables absorbed into it (absorption forest DFS)
  std::vector<std::vector<i64>> kids(n);
  for (i64 j = 0; j < n; ++j)
    if (parent[j] >= 0) kids[parent[j]].push_back(j);
  i64 pos = 0;
  std::vector<i64> stack;
  for (i64 root : elim_order) {
    stack.push_back(root);
    while (!stack.empty()) {
      i64 v = stack.back();
      stack.pop_back();
      perm[pos++] = v;
      for (i64 c : kids[v]) stack.push_back(c);
    }
  }
}

extern "C" {

void amd_order(i64 n, const i64* colptr, const i64* rowind, i64* perm) {
  amd_order_impl(n, colptr, rowind, perm);
}

// ---------------------------------------------------------------------------
// Minimum-degree ordering (external-degree variant on the elimination
// graph).  A must be structurally symmetric (pattern of A+A' is fine).
// ---------------------------------------------------------------------------
void mindeg_order(i64 n, const i64* colptr, const i64* rowind, i64* perm) {
  std::vector<std::vector<i64>> adj(n);
  for (i64 j = 0; j < n; ++j)
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      if (i != j) {
        adj[j].push_back(i);
        adj[i].push_back(j);
      }
    }
  for (i64 j = 0; j < n; ++j) {
    std::sort(adj[j].begin(), adj[j].end());
    adj[j].erase(std::unique(adj[j].begin(), adj[j].end()), adj[j].end());
  }
  std::vector<char> eliminated(n, 0);
  std::vector<i64> degree(n);
  for (i64 j = 0; j < n; ++j) degree[j] = (i64)adj[j].size();

  // degree buckets with lazy deletion: selection amortizes to
  // O(n + updates) instead of the naive O(n^2) scan
  std::vector<std::vector<i64>> bucket(n + 1);
  for (i64 j = 0; j < n; ++j) bucket[degree[j]].push_back(j);
  i64 cur = 0;
  auto push_bucket = [&](i64 v) {
    bucket[degree[v]].push_back(v);
    if (degree[v] < cur) cur = degree[v];
  };
  for (i64 k = 0; k < n; ++k) {
    i64 best = -1;
    while (best < 0) {
      while (cur <= n && bucket[cur].empty()) cur++;
      i64 cand = bucket[cur].back();
      bucket[cur].pop_back();
      // lazy: skip stale entries (eliminated or degree changed)
      if (!eliminated[cand] && degree[cand] == cur) best = cand;
    }
    perm[k] = best;
    eliminated[best] = 1;
    std::vector<i64> live;
    live.reserve(adj[best].size());
    for (i64 v : adj[best])
      if (!eliminated[v]) live.push_back(v);
    for (i64 v : live) {
      std::vector<i64> merged;
      merged.reserve(adj[v].size() + live.size());
      for (i64 w : adj[v])
        if (!eliminated[w]) merged.push_back(w);
      for (i64 w : live)
        if (w != v) merged.push_back(w);
      std::sort(merged.begin(), merged.end());
      merged.erase(std::unique(merged.begin(), merged.end()),
                   merged.end());
      adj[v].swap(merged);
      if ((i64)adj[v].size() != degree[v]) {
        degree[v] = (i64)adj[v].size();
        push_bucket(v);
      }
    }
    adj[best].clear();
    adj[best].shrink_to_fit();
  }
}

// ---------------------------------------------------------------------------
// Simplicial sparse LDL' Cholesky (up-looking).  Input: LOWER triangle of
// the (already permuted) symmetric matrix in CSC (rows i >= j).
// status: 0 ok, k+1 -> zero pivot at column k.
// ---------------------------------------------------------------------------

struct CholFactor {
  i64 n = 0;
  std::vector<i64> parent;
  std::vector<i64> Lp, Li;    // strictly-lower pattern of L
  std::vector<double> Lx;
  std::vector<double> D;
  // stored row-wise copy of the strict lower triangle of A, transposed
  // (per pivotal row), for refactorization
  std::vector<i64> tp, tj;
  std::vector<double> tx;
  std::vector<double> diag;
};

static void chol_build_rows(CholFactor* F, i64 n, const i64* colptr,
                            const i64* rowind, const double* values) {
  // row-wise view of strict lower triangle: for each row i, columns j < i
  std::vector<i64> cnt(n + 1, 0);
  for (i64 j = 0; j < n; ++j)
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      if (i > j) cnt[i + 1]++;
    }
  F->tp.assign(n + 1, 0);
  for (i64 i = 0; i < n; ++i) F->tp[i + 1] = F->tp[i] + cnt[i + 1];
  F->tj.assign(F->tp[n], 0);
  F->tx.assign(F->tp[n], 0.0);
  F->diag.assign(n, 0.0);
  std::vector<i64> w(n);
  for (i64 i = 0; i < n; ++i) w[i] = F->tp[i];
  for (i64 j = 0; j < n; ++j)
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      if (i > j) {
        F->tj[w[i]] = j;
        F->tx[w[i]] = values[p];
        w[i]++;
      } else if (i == j) {
        F->diag[j] = values[p];
      }
    }
}

static i64 chol_numeric(CholFactor* F) {
  i64 n = F->n;
  std::vector<i64> next(n);
  for (i64 j = 0; j < n; ++j) next[j] = F->Lp[j];
  std::vector<double> y(n, 0.0);
  std::vector<i64> pattern(n), mark(n, -1);
  i64 status = 0;
  for (i64 i = 0; i < n; ++i) {
    i64 top = n;
    mark[i] = i;
    for (i64 p = F->tp[i]; p < F->tp[i + 1]; ++p) {
      i64 k = F->tj[p];
      y[k] += F->tx[p];
      i64 len = 0;
      while (mark[k] != i) {
        pattern[len++] = k;
        mark[k] = i;
        k = F->parent[k];
      }
      while (len > 0) pattern[--top] = pattern[--len];
    }
    double di = F->diag[i];
    for (i64 t = top; t < n; ++t) {
      i64 k = pattern[t];
      double yk = y[k];
      y[k] = 0.0;
      double lik = yk / F->D[k];
      for (i64 p = F->Lp[k]; p < next[k]; ++p) y[F->Li[p]] -= F->Lx[p] * yk;
      di -= lik * yk;
      F->Li[next[k]] = i;
      F->Lx[next[k]] = lik;
      next[k]++;
    }
    if (di == 0.0 && status == 0) status = i + 1;
    F->D[i] = di;
  }
  return status;
}

void* ldl_factor(i64 n, const i64* colptr, const i64* rowind,
                 const double* values, i64* status) {
  CholFactor* F = new CholFactor();
  F->n = n;
  chol_build_rows(F, n, colptr, rowind, values);
  // etree from row patterns
  F->parent.assign(n, -1);
  {
    std::vector<i64> ancestor(n, -1);
    for (i64 i = 0; i < n; ++i)
      for (i64 p = F->tp[i]; p < F->tp[i + 1]; ++p) {
        i64 k = F->tj[p];
        while (k != -1 && k < i) {
          i64 nxt = ancestor[k];
          ancestor[k] = i;
          if (nxt == -1) F->parent[k] = i;
          k = nxt;
        }
      }
  }
  // column counts (strictly lower) via marked etree walks
  std::vector<i64> counts(n, 0), mark(n, -1);
  for (i64 i = 0; i < n; ++i) {
    mark[i] = i;
    for (i64 p = F->tp[i]; p < F->tp[i + 1]; ++p) {
      i64 k = F->tj[p];
      while (mark[k] != i) {
        counts[k]++;
        mark[k] = i;
        k = F->parent[k];
      }
    }
  }
  F->Lp.assign(n + 1, 0);
  for (i64 j = 0; j < n; ++j) F->Lp[j + 1] = F->Lp[j] + counts[j];
  F->Li.assign(F->Lp[n], 0);
  F->Lx.assign(F->Lp[n], 0.0);
  F->D.assign(n, 0.0);
  *status = chol_numeric(F);
  return F;
}

// numeric-only refactorization with the same pattern (values of the
// permuted lower triangle in the SAME CSC layout as the original call).
i64 ldl_refactor(void* handle, i64 n, const i64* colptr, const i64* rowind,
                 const double* values) {
  CholFactor* F = static_cast<CholFactor*>(handle);
  if (F->n != n) return -1;
  chol_build_rows(F, n, colptr, rowind, values);
  return chol_numeric(F);
}

void ldl_free(void* handle) { delete static_cast<CholFactor*>(handle); }

i64 ldl_lnnz(void* handle) {
  CholFactor* F = static_cast<CholFactor*>(handle);
  return (i64)F->Lx.size();
}

void ldl_get(void* handle, i64* Lp, i64* Li, double* Lx, double* D) {
  CholFactor* F = static_cast<CholFactor*>(handle);
  std::memcpy(Lp, F->Lp.data(), sizeof(i64) * (F->n + 1));
  if (!F->Li.empty()) {
    std::memcpy(Li, F->Li.data(), sizeof(i64) * F->Li.size());
    std::memcpy(Lx, F->Lx.data(), sizeof(double) * F->Lx.size());
  }
  std::memcpy(D, F->D.data(), sizeof(double) * F->n);
}

// solve with the LDL' factors, b: n x nrhs column-major, in place.
// mode: 0 = full LDL', 1 = L, 2 = D, 3 = L', 4 = LD, 5 = DL'
// (covers the reference cholmod.solve sys variants, cholmod.c:401).
void ldl_solve(void* handle, double* b, i64 nrhs, i64 mode) {
  CholFactor* F = static_cast<CholFactor*>(handle);
  i64 n = F->n;
  for (i64 r = 0; r < nrhs; ++r) {
    double* x = b + r * n;
    if (mode == 0 || mode == 1 || mode == 4) {
      for (i64 j = 0; j < n; ++j) {
        double xj = x[j];
        for (i64 p = F->Lp[j]; p < F->Lp[j + 1]; ++p)
          x[F->Li[p]] -= F->Lx[p] * xj;
      }
    }
    if (mode == 0 || mode == 2 || mode == 4 || mode == 5) {
      for (i64 j = 0; j < n; ++j) x[j] /= F->D[j];
    }
    if (mode == 0 || mode == 3 || mode == 5) {
      for (i64 j = n - 1; j >= 0; --j) {
        double xj = x[j];
        for (i64 p = F->Lp[j]; p < F->Lp[j + 1]; ++p)
          xj -= F->Lx[p] * x[F->Li[p]];
        x[j] = xj;
      }
    }
  }
}

void ldl_diag(void* handle, double* out) {
  CholFactor* F = static_cast<CholFactor*>(handle);
  std::memcpy(out, F->D.data(), sizeof(double) * F->n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hermitian complex LDL^H (same up-looking algorithm; D stays real,
// updates conjugate the stored L entries) — for cholmod 'z' support.
// ---------------------------------------------------------------------------

struct CholFactorZ {
  i64 n = 0;
  std::vector<i64> parent;
  std::vector<i64> Lp, Li;
  std::vector<cplx> Lx;
  std::vector<double> D;
  std::vector<i64> tp, tj;
  std::vector<cplx> tx;
  std::vector<double> diag;
};

static void cholz_build_rows(CholFactorZ* F, i64 n, const i64* colptr,
                             const i64* rowind, const cplx* values) {
  std::vector<i64> cnt(n + 1, 0);
  for (i64 j = 0; j < n; ++j)
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      if (i > j) cnt[i + 1]++;
    }
  F->tp.assign(n + 1, 0);
  for (i64 i = 0; i < n; ++i) F->tp[i + 1] = F->tp[i] + cnt[i + 1];
  F->tj.assign(F->tp[n], 0);
  F->tx.assign(F->tp[n], cplx(0));
  F->diag.assign(n, 0.0);
  std::vector<i64> w(n);
  for (i64 i = 0; i < n; ++i) w[i] = F->tp[i];
  for (i64 j = 0; j < n; ++j)
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      if (i > j) {
        F->tj[w[i]] = j;
        F->tx[w[i]] = values[p];  // A[i][j], lower triangle
        w[i]++;
      } else if (i == j) {
        F->diag[j] = values[p].real();
      }
    }
}

static i64 cholz_numeric(CholFactorZ* F) {
  i64 n = F->n;
  std::vector<i64> next(n);
  for (i64 j = 0; j < n; ++j) next[j] = F->Lp[j];
  std::vector<cplx> y(n, cplx(0));
  std::vector<i64> pattern(n), mark(n, -1);
  i64 status = 0;
  for (i64 i = 0; i < n; ++i) {
    i64 top = n;
    mark[i] = i;
    for (i64 p = F->tp[i]; p < F->tp[i + 1]; ++p) {
      i64 k = F->tj[p];
      y[k] += F->tx[p];
      i64 len = 0;
      while (mark[k] != i) {
        pattern[len++] = k;
        mark[k] = i;
        k = F->parent[k];
      }
      while (len > 0) pattern[--top] = pattern[--len];
    }
    double di = F->diag[i];
    for (i64 t = top; t < n; ++t) {
      i64 k = pattern[t];
      cplx yk = y[k];
      y[k] = cplx(0);
      cplx lik = yk / F->D[k];
      for (i64 p = F->Lp[k]; p < next[k]; ++p)
        y[F->Li[p]] -= std::conj(F->Lx[p]) * yk;
      di -= (lik * std::conj(yk)).real();
      F->Li[next[k]] = i;
      F->Lx[next[k]] = lik;
      next[k]++;
    }
    if (di == 0.0 && status == 0) status = i + 1;
    F->D[i] = di;
  }
  return status;
}

extern "C" {

void* ldl_factor_z(i64 n, const i64* colptr, const i64* rowind,
                   const cplx* values, i64* status) {
  CholFactorZ* F = new CholFactorZ();
  F->n = n;
  cholz_build_rows(F, n, colptr, rowind, values);
  F->parent.assign(n, -1);
  {
    std::vector<i64> ancestor(n, -1);
    for (i64 i = 0; i < n; ++i)
      for (i64 p = F->tp[i]; p < F->tp[i + 1]; ++p) {
        i64 k = F->tj[p];
        while (k != -1 && k < i) {
          i64 nxt = ancestor[k];
          ancestor[k] = i;
          if (nxt == -1) F->parent[k] = i;
          k = nxt;
        }
      }
  }
  std::vector<i64> counts(n, 0), mark(n, -1);
  for (i64 i = 0; i < n; ++i) {
    mark[i] = i;
    for (i64 p = F->tp[i]; p < F->tp[i + 1]; ++p) {
      i64 k = F->tj[p];
      while (mark[k] != i) {
        counts[k]++;
        mark[k] = i;
        k = F->parent[k];
      }
    }
  }
  F->Lp.assign(n + 1, 0);
  for (i64 j = 0; j < n; ++j) F->Lp[j + 1] = F->Lp[j] + counts[j];
  F->Li.assign(F->Lp[n], 0);
  F->Lx.assign(F->Lp[n], cplx(0));
  F->D.assign(n, 0.0);
  *status = cholz_numeric(F);
  return F;
}

i64 ldl_refactor_z(void* handle, i64 n, const i64* colptr,
                   const i64* rowind, const cplx* values) {
  CholFactorZ* F = static_cast<CholFactorZ*>(handle);
  if (F->n != n) return -1;
  cholz_build_rows(F, n, colptr, rowind, values);
  return cholz_numeric(F);
}

void ldl_free_z(void* handle) { delete static_cast<CholFactorZ*>(handle); }

i64 ldl_lnnz_z(void* handle) {
  return (i64)static_cast<CholFactorZ*>(handle)->Lx.size();
}

void ldl_get_z(void* handle, i64* Lp, i64* Li, cplx* Lx, double* D) {
  CholFactorZ* F = static_cast<CholFactorZ*>(handle);
  std::memcpy(Lp, F->Lp.data(), sizeof(i64) * (F->n + 1));
  if (!F->Li.empty()) {
    std::memcpy(Li, F->Li.data(), sizeof(i64) * F->Li.size());
    std::memcpy(Lx, F->Lx.data(), sizeof(cplx) * F->Lx.size());
  }
  std::memcpy(D, F->D.data(), sizeof(double) * F->n);
}

// mode semantics as ldl_solve (0 full LDL^H, 1 L, 2 D, 3 L^H, 4 LD, 5 DL^H)
void ldl_solve_z(void* handle, cplx* b, i64 nrhs, i64 mode) {
  CholFactorZ* F = static_cast<CholFactorZ*>(handle);
  i64 n = F->n;
  for (i64 r = 0; r < nrhs; ++r) {
    cplx* x = b + r * n;
    if (mode == 0 || mode == 1 || mode == 4) {
      for (i64 j = 0; j < n; ++j) {
        cplx xj = x[j];
        for (i64 p = F->Lp[j]; p < F->Lp[j + 1]; ++p)
          x[F->Li[p]] -= F->Lx[p] * xj;
      }
    }
    if (mode == 0 || mode == 2 || mode == 4 || mode == 5) {
      for (i64 j = 0; j < n; ++j) x[j] /= F->D[j];
    }
    if (mode == 0 || mode == 3 || mode == 5) {
      for (i64 j = n - 1; j >= 0; --j) {
        cplx xj = x[j];
        for (i64 p = F->Lp[j]; p < F->Lp[j + 1]; ++p)
          xj -= std::conj(F->Lx[p]) * x[F->Li[p]];
        x[j] = xj;
      }
    }
  }
}

void ldl_diag_z(void* handle, double* out) {
  CholFactorZ* F = static_cast<CholFactorZ*>(handle);
  std::memcpy(out, F->D.data(), sizeof(double) * F->n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse LU: left-looking Gilbert-Peierls with threshold partial pivoting,
// given a column preordering q.  Refactorization reuses pattern + pivots.
// ---------------------------------------------------------------------------

template <typename T>
struct LUFactor {
  i64 n = 0;
  std::vector<i64> q;     // column order: position k eliminates column q[k]
  std::vector<i64> pinv;  // pinv[orig row] = pivotal position
  std::vector<i64> Lp, Li;  // strictly-lower, row indices are PIVOTAL
  std::vector<T> Lx;
  std::vector<i64> Up, Ui;  // column k of U: entries Ui < k plus diag last
  std::vector<T> Ux;
  int singular = 0;
};

// iterative DFS computing the topological order of Reach(L, pattern of
// A(:,j)).  mark[v] == tag means visited.  Output nodes are pushed into
// xi[top-1 ...]; returns new top.  Node ids are PIVOTAL indices for
// finished columns, ORIGINAL row ids for non-pivotal rows (no L column).
template <typename T>
static i64 lu_reach(LUFactor<T>* F, i64 jcol, const i64* colptr,
                    const i64* rowind, std::vector<i64>& mark, i64 tag,
                    std::vector<i64>& xi, std::vector<i64>& pstack,
                    i64 top) {
  for (i64 p = colptr[jcol]; p < colptr[jcol + 1]; ++p) {
    i64 start = rowind[p];  // original row id
    if (mark[start] == tag) continue;
    i64 head = 0;
    xi[head] = start;
    pstack[head] = -1;
    while (head >= 0) {
      i64 node = xi[head];
      i64 ni = F->pinv[node];
      if (pstack[head] < 0) {
        mark[node] = tag;
        pstack[head] = (ni >= 0) ? F->Lp[ni] : -2;
      }
      bool descended = false;
      if (ni >= 0) {
        for (i64 pp = pstack[head]; pp < F->Lp[ni + 1]; ++pp) {
          // L row indices are pivotal positions of rows seen when the
          // column was formed; convert back: we store ORIGINAL row ids in
          // Li during factorization and remap at the end, so during
          // factorization Li holds original ids.
          i64 child = F->Li[pp];
          if (mark[child] != tag) {
            pstack[head] = pp + 1;
            ++head;
            xi[head] = child;
            pstack[head] = -1;
            descended = true;
            break;
          }
        }
        if (!descended) pstack[head] = F->Lp[ni + 1];
      }
      if (!descended) {
        xi[--top] = node;
        --head;
      }
    }
  }
  return top;
}

template <typename T>
static void* lu_factor_impl(i64 n, const i64* colptr, const i64* rowind,
                            const T* values, const i64* qperm, i64* status,
                            double pivot_tol) {
  LUFactor<T>* F = new LUFactor<T>();
  F->n = n;
  F->q.assign(qperm, qperm + n);
  F->pinv.assign(n, -1);
  F->Lp.assign(n + 1, 0);
  F->Up.assign(n + 1, 0);
  std::vector<T> x(n, T(0));
  std::vector<i64> xi(n), pstack(n), mark(n, -1);
  *status = 0;

  for (i64 col = 0; col < n; ++col) {
    i64 j = F->q[col];
    i64 top = lu_reach(F, j, colptr, rowind, mark, col, xi, pstack, n);
    // scatter A(:,j)
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p)
      x[rowind[p]] += values[p];
    // eliminate along topological order
    for (i64 t = top; t < n; ++t) {
      i64 node = xi[t];
      i64 ni = F->pinv[node];
      if (ni < 0) continue;
      T xk = x[node];
      if (xk != T(0))
        for (i64 pp = F->Lp[ni]; pp < F->Lp[ni + 1]; ++pp)
          x[F->Li[pp]] -= F->Lx[pp] * xk;
    }
    // pivot among non-pivotal rows
    i64 pivrow = -1;
    double pivmag = -1.0;
    for (i64 t = top; t < n; ++t) {
      i64 node = xi[t];
      if (F->pinv[node] < 0) {
        double m = mag(x[node]);
        if (m > pivmag) {
          pivmag = m;
          pivrow = node;
        }
      }
    }
    if (pivrow < 0 || pivmag == 0.0) {
      if (*status == 0) *status = col + 1;
      F->singular = 1;
      if (pivrow < 0)
        for (i64 r = 0; r < n; ++r)
          if (F->pinv[r] < 0) {
            pivrow = r;
            break;
          }
      x[pivrow] = T(1e-300);
    } else if (F->pinv[j] < 0 && mag(x[j]) >= pivot_tol * pivmag) {
      pivrow = j;  // prefer the diagonal when acceptable
    }
    T pivval = x[pivrow];
    // emit U entries (pivotal rows) in increasing pivotal order: collect
    std::vector<std::pair<i64, T>> ucol;
    for (i64 t = top; t < n; ++t) {
      i64 node = xi[t];
      i64 ni = F->pinv[node];
      if (ni >= 0) ucol.emplace_back(ni, x[node]);
    }
    std::sort(ucol.begin(), ucol.end(),
              [](const std::pair<i64, T>& a, const std::pair<i64, T>& b) {
                return a.first < b.first;
              });
    for (auto& kv : ucol) {
      F->Ui.push_back(kv.first);
      F->Ux.push_back(kv.second);
    }
    F->Ui.push_back(col);
    F->Ux.push_back(pivval);
    F->Up[col + 1] = (i64)F->Ui.size();
    // emit L column: non-pivotal rows except the pivot, original row ids
    F->pinv[pivrow] = col;
    for (i64 t = top; t < n; ++t) {
      i64 node = xi[t];
      if (F->pinv[node] < 0) {
        F->Li.push_back(node);
        F->Lx.push_back(x[node] / pivval);
      }
      x[node] = T(0);
    }
    F->Lp[col + 1] = (i64)F->Li.size();
  }
  return F;
}

// refactorization: replay with fixed pattern and pivot order.
template <typename T>
static i64 lu_refactor_impl(void* handle, i64 n, const i64* colptr,
                            const i64* rowind, const T* values) {
  LUFactor<T>* F = static_cast<LUFactor<T>*>(handle);
  if (F->n != n) return -1;
  std::vector<T> x(n, T(0));  // indexed by ORIGINAL row id (L entries)
  std::vector<T> xu(n, T(0));  // indexed by pivotal position (U entries)
  i64 status = 0;
  for (i64 col = 0; col < n; ++col) {
    i64 j = F->q[col];
    for (i64 p = colptr[j]; p < colptr[j + 1]; ++p) {
      i64 i = rowind[p];
      i64 ni = F->pinv[i];
      if (ni >= 0 && ni <= col) {
        if (ni < col) xu[ni] += values[p];
        else x[i] += values[p];  // ni == col: the pivot row
      } else {
        x[i] += values[p];
      }
    }
    // Hmm: the pivot row has pinv == col; its value accumulates in x[i].
    // eliminate along stored U pattern (sorted increasing => topological)
    for (i64 p = F->Up[col]; p < F->Up[col + 1] - 1; ++p) {
      i64 k = F->Ui[p];
      T xk = xu[k];
      xu[k] = T(0);
      F->Ux[p] = xk;
      if (xk != T(0)) {
        for (i64 pp = F->Lp[k]; pp < F->Lp[k + 1]; ++pp) {
          i64 i = F->Li[pp];  // original row id
          i64 ni = F->pinv[i];
          if (ni >= 0 && ni < col) xu[ni] -= F->Lx[pp] * xk;
          else x[i] -= F->Lx[pp] * xk;
        }
      }
    }
    // pivot value: the row with pinv == col
    // find it: the original row r with F->pinv[r] == col is fixed; we can
    // precompute prow once.
    // For efficiency, precompute prow outside the loop (see below).
    // Here we rely on prow array:
    // (filled lazily)
    static thread_local std::vector<i64> prow;
    if (col == 0) {
      prow.assign(n, 0);
      for (i64 r = 0; r < n; ++r) prow[F->pinv[r]] = r;
    }
    i64 pr = prow[col];
    T piv = x[pr];
    x[pr] = T(0);
    F->Ux[F->Up[col + 1] - 1] = piv;
    if (piv == T(0)) {
      if (status == 0) status = col + 1;
      piv = T(1e-300);
    }
    for (i64 p = F->Lp[col]; p < F->Lp[col + 1]; ++p) {
      i64 i = F->Li[p];
      F->Lx[p] = x[i] / piv;
      x[i] = T(0);
    }
  }
  return status;
}

template <typename T>
static void lu_finalize_rows(LUFactor<T>*) {}

// solve: trans 0 -> A x = b, 1 -> A^T x = b, 2 -> A^H x = b.
// b is n x nrhs column-major, overwritten with the solution.
template <typename T>
static void lu_solve_impl(void* handle, T* b, i64 nrhs, i64 trans) {
  LUFactor<T>* F = static_cast<LUFactor<T>*>(handle);
  i64 n = F->n;
  std::vector<T> y(n);
  for (i64 r = 0; r < nrhs; ++r) {
    T* bcol = b + r * n;
    if (trans == 0) {
      // A = P^T L U Q^T with row perm pinv, col perm q:
      // solve L y = P b, U w = y, x[q[k]] = w[k]
      for (i64 i = 0; i < n; ++i) y[F->pinv[i]] = bcol[i];
      for (i64 k = 0; k < n; ++k) {
        T xk = y[k];
        if (xk != T(0))
          for (i64 p = F->Lp[k]; p < F->Lp[k + 1]; ++p)
            y[F->pinv[F->Li[p]]] -= F->Lx[p] * xk;
      }
      for (i64 k = n - 1; k >= 0; --k) {
        T piv = F->Ux[F->Up[k + 1] - 1];
        T xk = y[k] / piv;
        y[k] = xk;
        for (i64 p = F->Up[k]; p < F->Up[k + 1] - 1; ++p)
          y[F->Ui[p]] -= F->Ux[p] * xk;
      }
      for (i64 k = 0; k < n; ++k) bcol[F->q[k]] = y[k];
    } else {
      bool cj = (trans == 2);
      // A^T x = b: solve U^T z = b[q], L^T w = z, x = P^T w
      for (i64 k = 0; k < n; ++k) y[k] = bcol[F->q[k]];
      for (i64 k = 0; k < n; ++k) {
        T sum = y[k];
        for (i64 p = F->Up[k]; p < F->Up[k + 1] - 1; ++p) {
          T u = F->Ux[p];
          if (cj) u = conj_of(u);
          sum -= u * y[F->Ui[p]];
        }
        T piv = F->Ux[F->Up[k + 1] - 1];
        if (cj) piv = conj_of(piv);
        y[k] = sum / piv;
      }
      for (i64 k = n - 1; k >= 0; --k) {
        T sum = y[k];
        for (i64 p = F->Lp[k]; p < F->Lp[k + 1]; ++p) {
          T l = F->Lx[p];
          if (cj) l = conj_of(l);
          sum -= l * y[F->pinv[F->Li[p]]];
        }
        y[k] = sum;
      }
      for (i64 i = 0; i < n; ++i) bcol[i] = y[F->pinv[i]];
    }
  }
}

template <typename T>
static void lu_det_impl(void* handle, T* det) {
  LUFactor<T>* F = static_cast<LUFactor<T>*>(handle);
  i64 n = F->n;
  T d = T(1);
  for (i64 k = 0; k < n; ++k) d *= F->Ux[F->Up[k + 1] - 1];
  auto perm_sign = [n](const std::vector<i64>& perm) {
    std::vector<char> seen(n, 0);
    int sign = 1;
    for (i64 i = 0; i < n; ++i) {
      if (seen[i]) continue;
      i64 len = 0, j = i;
      while (!seen[j]) {
        seen[j] = 1;
        j = perm[j];
        len++;
      }
      if (len % 2 == 0) sign = -sign;
    }
    return sign;
  };
  int s = perm_sign(F->pinv) * perm_sign(F->q);
  *det = d * T(s);
}

// log-magnitude + phase determinant: survives products whose running
// value under/overflows double even when the final det is representable
// (the reference reports such dets via interleaved Udiag*Rs products,
// klu.c:771; log space is strictly more robust)
template <typename T>
static void lu_logdet_impl(void* handle, double* logmag, T* phase) {
  LUFactor<T>* F = static_cast<LUFactor<T>*>(handle);
  i64 n = F->n;
  double lm = 0.0;
  T ph = T(1);
  for (i64 k = 0; k < n; ++k) {
    T u = F->Ux[F->Up[k + 1] - 1];
    double a = std::abs(u);
    if (a == 0.0) {
      *logmag = -std::numeric_limits<double>::infinity();
      *phase = T(0);
      return;
    }
    lm += std::log(a);
    ph *= u / a;
  }
  auto perm_sign = [n](const std::vector<i64>& perm) {
    std::vector<char> seen(n, 0);
    int sign = 1;
    for (i64 i = 0; i < n; ++i) {
      if (seen[i]) continue;
      i64 len = 0, j = i;
      while (!seen[j]) {
        seen[j] = 1;
        j = perm[j];
        len++;
      }
      if (len % 2 == 0) sign = -sign;
    }
    return sign;
  };
  *logmag = lm;
  *phase = ph * T(perm_sign(F->pinv) * perm_sign(F->q));
}

template <typename T>
static void lu_sizes_impl(void* handle, i64* lnnz, i64* unnz) {
  LUFactor<T>* F = static_cast<LUFactor<T>*>(handle);
  *lnnz = (i64)F->Lx.size() + F->n;
  *unnz = (i64)F->Ux.size();
}

// export factors with PIVOTAL row indices in L (so that P A Q = L U with
// P[k] = prow[k]) and explicit unit diagonal on L.
template <typename T>
static void lu_get_impl(void* handle, i64* Lp, i64* Li, T* Lx, i64* Up,
                        i64* Ui, T* Ux, i64* prow, i64* qcol) {
  LUFactor<T>* F = static_cast<LUFactor<T>*>(handle);
  i64 n = F->n;
  i64 pos = 0;
  for (i64 k = 0; k < n; ++k) {
    Lp[k] = pos;
    Li[pos] = k;
    Lx[pos] = T(1);
    pos++;
    for (i64 p = F->Lp[k]; p < F->Lp[k + 1]; ++p) {
      Li[pos] = F->pinv[F->Li[p]];
      Lx[pos] = F->Lx[p];
      pos++;
    }
  }
  Lp[n] = pos;
  std::memcpy(Up, F->Up.data(), sizeof(i64) * (n + 1));
  if (!F->Ui.empty()) {
    std::memcpy(Ui, F->Ui.data(), sizeof(i64) * F->Ui.size());
    std::memcpy(Ux, F->Ux.data(), sizeof(T) * F->Ux.size());
  }
  for (i64 i = 0; i < n; ++i) prow[F->pinv[i]] = i;
  std::memcpy(qcol, F->q.data(), sizeof(i64) * n);
}

template <typename T>
static i64 lu_singular_impl(void* handle) {
  return static_cast<LUFactor<T>*>(handle)->singular;
}

extern "C" {

// --- C ABI (double) ---
void* lu_factor_d(i64 n, const i64* cp, const i64* ri, const double* vx,
                  const i64* q, i64* status, double tol) {
  return lu_factor_impl<double>(n, cp, ri, vx, q, status, tol);
}
i64 lu_refactor_d(void* h, i64 n, const i64* cp, const i64* ri,
                  const double* vx) {
  return lu_refactor_impl<double>(h, n, cp, ri, vx);
}
void lu_solve_d(void* h, double* b, i64 nrhs, i64 trans) {
  lu_solve_impl<double>(h, b, nrhs, trans);
}
void lu_det_d(void* h, double* det) { lu_det_impl<double>(h, det); }
void lu_logdet_d(void* h, double* lm, double* ph) {
  lu_logdet_impl<double>(h, lm, ph);
}
void lu_sizes_d(void* h, i64* l, i64* u) { lu_sizes_impl<double>(h, l, u); }
void lu_get_d(void* h, i64* Lp, i64* Li, double* Lx, i64* Up, i64* Ui,
              double* Ux, i64* p, i64* q) {
  lu_get_impl<double>(h, Lp, Li, Lx, Up, Ui, Ux, p, q);
}
i64 lu_singular_d(void* h) { return lu_singular_impl<double>(h); }
void lu_free_d(void* h) { delete static_cast<LUFactor<double>*>(h); }

// --- C ABI (complex double) ---
void* lu_factor_z(i64 n, const i64* cp, const i64* ri, const cplx* vx,
                  const i64* q, i64* status, double tol) {
  return lu_factor_impl<cplx>(n, cp, ri, vx, q, status, tol);
}
i64 lu_refactor_z(void* h, i64 n, const i64* cp, const i64* ri,
                  const cplx* vx) {
  return lu_refactor_impl<cplx>(h, n, cp, ri, vx);
}
void lu_solve_z(void* h, cplx* b, i64 nrhs, i64 trans) {
  lu_solve_impl<cplx>(h, b, nrhs, trans);
}
void lu_det_z(void* h, cplx* det) { lu_det_impl<cplx>(h, det); }
void lu_logdet_z(void* h, double* lm, cplx* ph) {
  lu_logdet_impl<cplx>(h, lm, ph);
}
void lu_sizes_z(void* h, i64* l, i64* u) { lu_sizes_impl<cplx>(h, l, u); }
void lu_get_z(void* h, i64* Lp, i64* Li, cplx* Lx, i64* Up, i64* Ui,
              cplx* Ux, i64* p, i64* q) {
  lu_get_impl<cplx>(h, Lp, Li, Lx, Up, Ui, Ux, p, q);
}
i64 lu_singular_z(void* h) { return lu_singular_impl<cplx>(h); }
void lu_free_z(void* h) { delete static_cast<LUFactor<cplx>*>(h); }

}  // extern "C"
