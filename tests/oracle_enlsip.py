"""Plain-numpy transliteration of the reference ENLSIP loop — TEST ORACLE.

This module deliberately mirrors the structure of the reference Julia
implementation (/root/reference/src/enlsip_functions.jl + structures.jl)
function by function, so the JAX solver's golden trajectories can be
pinned to *reference-derived* sequences instead of to the implementation
itself.  It is test-only code: eager,
sequential, float64, no JAX.  Every function cites the reference lines
it transliterates.  Known reference crash sites are guarded with the
same repairs the production solver documents (PARITY.md D3/D4 and the
SUBSPC prefix clamps) — each guard is marked ORACLE-GUARD below.

Index convention: 0-based everywhere; working-set `active`/`inactive`
arrays hold 0-based constraint indices with -1 as the empty sentinel
(the Julia uses 1-based with 0 as sentinel, structures.jl:209-229).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np


# ------------------------------------------------------------ QR (L0)

class QRP:
    """Column-pivoted Householder QR, full Q: M[:, perm] = Q @ R.

    Stands in for Julia's ``qr(M, ColumnNorm())`` (LAPACK dgeqp3):
    greedy max-column-norm pivoting, so the pivot sequence and |diag R|
    match LAPACK's in exact arithmetic."""

    def __init__(self, M: np.ndarray):
        M = np.asarray(M, float)
        mr, nc = M.shape
        Q = np.eye(mr)
        R = M.copy()
        perm = np.arange(nc)
        for k in range(min(mr, nc)):
            norms = np.sum(R[k:, k:] ** 2, axis=0)
            j = k + int(np.argmax(norms))
            if j != k:
                R[:, [k, j]] = R[:, [j, k]]
                perm[[k, j]] = perm[[j, k]]
            v = R[k:, k].copy()
            nv = np.linalg.norm(v)
            if nv > 0.0:
                v0 = v[0]
                alpha = -math.copysign(nv, v0 if v0 != 0.0 else 1.0)
                v[0] -= alpha
                vn2 = np.dot(v, v)
                if vn2 > 0.0:
                    R[k:, k:] -= np.outer(v, (2.0 / vn2) * (v @ R[k:, k:]))
                    Q[:, k:] -= np.outer(Q[:, k:] @ v, (2.0 / vn2) * v)
                    R[k + 1:, k] = 0.0
                    R[k, k] = alpha
        self.Q = Q          # (mr, mr) full
        self.R = R[:nc, :]  # (min? keep nc rows like Julia econ R)
        self.Rfull = R
        self.p = perm       # 0-based permutation: M[:, p] = Q @ Rfull

    def diag(self) -> np.ndarray:
        k = min(self.Rfull.shape)
        return np.diagonal(self.Rfull)[:k].copy()

    def perm_matrix(self) -> np.ndarray:
        nc = len(self.p)
        P = np.zeros((nc, nc))
        P[self.p, np.arange(nc)] = 1.0
        return P


def invperm(p: np.ndarray) -> np.ndarray:
    ip = np.empty_like(p)
    ip[p] = np.arange(len(p))
    return ip


def solve_upper(R: np.ndarray, b: np.ndarray) -> np.ndarray:
    import scipy.linalg as _sla  # pragma: no cover
    raise RuntimeError("unused")


def _usolve(R, b):
    """UpperTriangular(R) \\ b."""
    n = len(b)
    x = np.zeros(n)
    for i in range(n - 1, -1, -1):
        x[i] = (b[i] - R[i, i + 1:n] @ x[i + 1:n]) / R[i, i]
    return x


def _lsolve(L, b):
    """LowerTriangular(L) \\ b."""
    n = len(b)
    x = np.zeros(n)
    for i in range(n):
        x[i] = (b[i] - L[i, :i] @ x[:i]) / L[i, i]
    return x


# ------------------------------------------------- structures.jl layer

@dataclasses.dataclass
class Iteration:
    """structures.jl:63-91."""
    x: np.ndarray
    p: np.ndarray
    rx: np.ndarray
    cx: np.ndarray
    t: int
    alpha: float
    index_alpha_upp: int   # -1 = none (Julia 0)
    lam: np.ndarray
    w: np.ndarray
    rankA: int
    rankJ2: int
    dimA: int
    dimJ2: int
    b_gn: np.ndarray
    d_gn: np.ndarray
    predicted_reduction: float
    progress: float
    grad_res: float
    speed: float
    beta: float
    restart: bool
    first: bool
    add: bool
    delete: bool
    index_del: int         # -1 = none (Julia 0)
    code: int
    nb_newton_steps: int

    def copy(self) -> "Iteration":
        return Iteration(
            self.x.copy(), self.p.copy(), self.rx.copy(), self.cx.copy(),
            self.t, self.alpha, self.index_alpha_upp, self.lam.copy(),
            self.w.copy(), self.rankA, self.rankJ2, self.dimA, self.dimJ2,
            self.b_gn.copy(), self.d_gn.copy(), self.predicted_reduction,
            self.progress, self.grad_res, self.speed, self.beta,
            self.restart, self.first, self.add, self.delete,
            self.index_del, self.code, self.nb_newton_steps)


@dataclasses.dataclass
class Constraint:
    """structures.jl:145-150."""
    cx: np.ndarray
    A: np.ndarray
    scaling: bool
    diag_scale: np.ndarray


def evaluate_scaling(C: Constraint) -> None:
    """EVSCAL, structures.jl:160-178."""
    t = C.A.shape[0]
    eps_rel = np.finfo(float).eps
    C.diag_scale = np.zeros(t)
    for i in range(t):
        row_i = np.linalg.norm(C.A[i, :])
        C.diag_scale[i] = row_i
        if C.scaling:
            if abs(row_i) < eps_rel:
                row_i = 1.0
            C.A[i, :] /= row_i
            C.cx[i] /= row_i
            C.diag_scale[i] = 1.0 / row_i


@dataclasses.dataclass
class WorkingSet:
    """structures.jl:209-229 (0-based indices, -1 sentinel)."""
    q: int
    t: int
    l: int
    active: np.ndarray
    inactive: np.ndarray


def remove_constraint(W: WorkingSet, s: int) -> None:
    """DELETE, structures.jl:234-249. s is a 0-based active slot."""
    l, t = W.l, W.t
    W.inactive[l - t] = W.active[s]
    head = np.sort(W.inactive[: l - t + 1])
    W.inactive[: l - t + 1] = head
    for i in range(s, t - 1):
        W.active[i] = W.active[i + 1]
    W.active[t - 1] = -1
    W.t -= 1


def add_constraint(W: WorkingSet, s: int) -> None:
    """ADDIT, structures.jl:254-267. s is a 0-based inactive slot."""
    l, t = W.l, W.t
    W.active[t] = W.inactive[s]
    head = np.sort(W.active[: t + 1])
    W.active[: t + 1] = head
    for i in range(s, l - t - 1):
        W.inactive[i] = W.inactive[i + 1]
    W.inactive[l - t - 1] = -1
    W.t += 1


# ------------------------------------------------ eval-counting layer

class Fns:
    """cnls_model.jl:9-62 counting wrappers (res/cons + jacobians)."""

    def __init__(self, res, jac_res, cons, jac_cons):
        self._res, self._jac_res = res, jac_res
        self._cons, self._jac_cons = cons, jac_cons
        self.nb_reseval = 0
        self.nb_jacres = 0
        self.nb_conseval = 0
        self.nb_jaccons = 0

    def res(self, x):
        self.nb_reseval += 1
        return np.asarray(self._res(x), float)

    def jac_res(self, x):
        self.nb_jacres += 1
        return np.asarray(self._jac_res(x), float)

    def cons(self, x):
        self.nb_conseval += 1
        return np.asarray(self._cons(x), float)

    def jac_cons(self, x):
        self.nb_jaccons += 1
        return np.asarray(self._jac_cons(x), float)


# --------------------------------------------------- enlsip_functions

def pseudo_rank(diag_T: np.ndarray, eps_rank: float) -> int:
    """enlsip_functions.jl:17-31 (incl. the sqrt(len) factor)."""
    if len(diag_T) == 0 or abs(diag_T[0]) < eps_rank:
        return 0
    ld = len(diag_T)
    tol = abs(diag_T[0]) * math.sqrt(ld) * eps_rank
    r = 1
    while r < ld and abs(diag_T[r - 1]) > tol:
        r += 1
    return r - (0 if (r == ld and abs(diag_T[r - 1]) > tol) else 1)


def sub_search_direction(J1, rx, cx, F_A: QRP, F_L11: Optional[QRP],
                         F_J2: QRP, n, t, rankA, dimA, dimJ2, code):
    """SUBDIR, enlsip_functions.jl:116-153."""
    if code == 1:
        b = -cx[F_A.p]
        p1 = _lsolve(F_A.R.T[:t, :t], b)
        d_temp = -J1 @ p1 - rx
        d = F_A_Q_apply = F_J2.Q.T @ d_temp
        dp2 = _usolve(F_J2.R[:dimJ2, :dimJ2], d[:dimJ2])
        p2 = np.concatenate([dp2, np.zeros(n - t - dimJ2)])[invperm(F_J2.p)]
    else:  # code == -1
        b_buff = -cx[F_A.p]
        b = F_L11.Q.T @ b_buff
        dp1 = _usolve(F_L11.R[:dimA, :dimA], b[:dimA])
        p1 = np.concatenate([dp1, np.zeros(t - dimA)])[invperm(F_L11.p)][:rankA]
        d_temp = -J1 @ p1 - rx
        d = F_J2.Q.T @ d_temp
        dp2 = _usolve(F_J2.R[:dimJ2, :dimJ2], d[:dimJ2])
        p2 = np.concatenate([dp2, np.zeros(n - rankA - dimJ2)])[invperm(F_J2.p)]
    p = F_A.Q @ np.concatenate([p1, p2])
    return p, b, d


def gn_search_direction(J, rx, cx, F_A: QRP, F_L11, rankA, t, eps_rank,
                        it: Iteration):
    """GNSRCH, enlsip_functions.jl:206-233."""
    code = 1 if rankA == t else -1
    n = J.shape[1]
    JQ1 = J @ F_A.Q
    J1, J2 = JQ1[:, :rankA], JQ1[:, rankA:]
    F_J2 = QRP(J2)
    rankJ2 = pseudo_rank(F_J2.diag(), eps_rank)
    p_gn, b_gn, d_gn = sub_search_direction(
        J1, rx, cx, F_A, F_L11, F_J2, n, t, rankA, rankA, rankJ2, code)
    it.rankA, it.rankJ2 = rankA, rankJ2
    it.dimA, it.dimJ2 = rankA, rankJ2
    it.b_gn, it.d_gn = b_gn, d_gn
    return p_gn, F_J2


def hessian_res(fns: Fns, x, rx, n, m):
    """HESSF, enlsip_functions.jl:243-278 (2nd-order central FD)."""
    e1 = np.finfo(float).eps ** (1.0 / 3.0)
    B = np.zeros((n, n))
    for k in range(n):
        for j in range(k + 1):
            ek = max(abs(x[k]), 1.0) * e1
            ej = max(abs(x[j]), 1.0) * e1
            xw = x.copy(); xw[j] += ej; xw[k] += ek
            f1 = fns.res(xw)
            xw = x.copy(); xw[j] -= ej; xw[k] += ek
            f2 = fns.res(xw)
            xw = x.copy(); xw[j] += ej; xw[k] -= ek
            f3 = fns.res(xw)
            xw = x.copy(); xw[j] -= ej; xw[k] -= ek
            f4 = fns.res(xw)
            s = float(np.dot(f1 - f2 - f3 + f4, rx)) / (4 * ej * ek)
            B[k, j] = s
            if j != k:
                B[j, k] = s
    return B


def hessian_cons(fns: Fns, x, lam, active, n, l, t):
    """HESSH, enlsip_functions.jl:288-328."""
    e1 = np.finfo(float).eps ** (1.0 / 3.0)
    B = np.zeros((n, n))
    idx = active[:t]
    for k in range(n):
        for j in range(k + 1):
            ek = max(abs(x[k]), 1.0) * e1
            ej = max(abs(x[j]), 1.0) * e1
            xw = x.copy(); xw[j] += ej; xw[k] += ek
            f1 = fns.cons(xw)
            xw = x.copy(); xw[j] -= ej; xw[k] += ek
            f2 = fns.cons(xw)
            xw = x.copy(); xw[j] += ej; xw[k] -= ek
            f3 = fns.cons(xw)
            xw = x.copy(); xw[j] -= ej; xw[k] -= ek
            f4 = fns.cons(xw)
            s = 0.0
            for i in range(t):
                ii = idx[i]
                s += (f1[ii] - f2[ii] - f3[ii] + f4[ii]) * lam[i]
            s /= (4.0 * ek * ej)
            B[k, j] = s
            if k != j:
                B[j, k] = s
    return B


def newton_search_direction(fns: Fns, x, active_cx, W: WorkingSet, lam,
                            rx, J, F_A: QRP, F_L11, rankA):
    """NEWTON, enlsip_functions.jl:348-423."""
    m, n = J.shape
    t, l = W.t, W.l
    if t == rankA:
        b = -active_cx[F_A.p]
        p1 = _lsolve(F_A.R.T[:t, :t], b)
    else:  # t > rankA
        b = F_L11.Q.T @ (-active_cx[F_A.p])
        dp1 = _usolve(F_L11.R[:rankA, :rankA], b[:rankA])
        p1 = F_L11.perm_matrix()[:rankA, :rankA] @ dp1
    if rankA == n:
        # ORACLE-GUARD: reference returns a bare p1 here (:379-381),
        # which would crash the caller's tuple unpack (PARITY.md D3).
        return p1, False
    JQ1 = J @ F_A.Q
    J1, J2 = JQ1[:, :rankA], JQ1[:, rankA:]
    r_mat = hessian_res(fns, x, rx, n, m)
    c_mat = hessian_cons(fns, x, lam, W.active, n, l, t)
    Gamma = r_mat - c_mat
    E = F_A.Q.T @ Gamma @ F_A.Q
    if t > rankA:
        vp2 = F_L11.p
        E = E[np.ix_(vp2, vp2)]
    E21 = E[rankA:n, :rankA]
    E22 = E[rankA:n, rankA:n]
    W22 = E22 + J2.T @ J2
    W21 = E21 + J2.T @ J1
    d = -W21 @ p1 - J2.T @ rx
    sW22 = 0.5 * (W22 + W22.T)
    try:
        L = np.linalg.cholesky(sW22)
    except np.linalg.LinAlgError:
        return np.zeros(n), True
    y = _lsolve(L, d)
    p2 = _usolve(L.T, y)
    p = F_A.Q @ np.concatenate([p1, p2])
    return p, False


def first_lagrange_mult_estimate(A, gfx, cx, scaling, diag_scale,
                                 F: QRP, it: Iteration, eps_rank):
    """MULEST, enlsip_functions.jl:461-508."""
    t, n = A.shape
    prankA = pseudo_rank(F.diag(), eps_rank)
    b = F.Q.T @ gfx
    v = np.zeros(t)
    v[:prankA] = _usolve(F.R[:prankA, :prankA], b[:prankA])
    lam_ls = v[invperm(F.p)]
    it.grad_res = float(np.linalg.norm(b[prankA:n])) if n > prankA else 0.0
    b2 = -cx[F.p]
    y = np.zeros(t)
    y[:prankA] = _lsolve(F.R.T[:prankA, :prankA], b2[:prankA])
    u = np.zeros(t)
    u[:prankA] = _usolve(F.R[:prankA, :prankA], y[:prankA])
    lam = lam_ls + u[invperm(F.p)]
    if scaling:
        lam = lam * diag_scale
    return lam


def second_lagrange_mult_estimate(J, F_A: QRP, rx, p_gn, t, scaling,
                                  diag_scale, eps_rank=None):
    """LEAEST, enlsip_functions.jl:514-537."""
    if eps_rank is None:
        eps_rank = math.sqrt(np.finfo(float).eps)
    prankA = pseudo_rank(F_A.diag(), eps_rank)
    J1 = (J @ F_A.Q)[:, :t]
    b = J1.T @ (rx + J @ p_gn)
    v = np.zeros(t)
    v[:prankA] = _usolve(F_A.R[:prankA, :prankA], b[:prankA])
    lam = v[invperm(F_A.p)]
    if scaling:
        lam = lam * diag_scale
    return lam


def minmax_lagrangian_mult(lam, W: WorkingSet, C: Constraint):
    """enlsip_functions.jl:540-564."""
    q, t = W.q, W.t
    lam_abs_max = 0.0
    sigmin = math.inf
    if t > q:
        lam_abs_max = float(np.max(np.abs(lam)))
        rows = (1.0 / C.diag_scale) if C.scaling else C.diag_scale
        sq_rel = math.sqrt(np.finfo(float).eps)
        for i in range(q, t):
            li = lam[i]
            if li * rows[i] <= -sq_rel and li < sigmin:
                sigmin = li
    return sigmin, lam_abs_max


def check_constraint_deletion(q, A, lam, scaling, diag_scale, grad_res):
    """SIGNCH, enlsip_functions.jl:574-603. Returns 0-based slot or -1."""
    t = A.shape[0]
    delta = 10.0
    lam_max = 1.0 if len(lam) == 0 else float(np.max(np.abs(lam)))
    sq_rel = math.sqrt(np.finfo(float).eps) * lam_max
    s = -1
    if t > q:
        e = sq_rel
        for i in range(q, t):
            row_i = (1.0 / diag_scale[i]) if scaling else diag_scale[i]
            if row_i * lam[i] <= sq_rel and row_i * lam[i] <= e:
                e = row_i * lam[i]
                s = i
        if grad_res > -e * delta:
            s = -1
    return s


def evaluate_violated_constraints(cx, W: WorkingSet, index_alpha_upp, n):
    """EVADD, enlsip_functions.jl:608-650."""
    eps = math.sqrt(np.finfo(float).eps)
    delta = 0.1
    bnd = min(W.l, n)
    added = False
    if W.l > W.t:
        i = 0
        while i < W.l - W.t:
            k = W.inactive[i]
            if cx[k] < eps or (k == index_alpha_upp and cx[k] < delta):
                if W.t >= bnd:
                    worst_k = -1
                    worst_val = -math.inf
                    for j in range(W.q, W.t):
                        jj = W.active[j]
                        if cx[jj] > worst_val:
                            worst_val = cx[jj]
                            worst_k = j
                    if worst_k >= 0 and worst_val > cx[k]:
                        remove_constraint(W, worst_k)
                    else:
                        i += 1
                        continue
                add_constraint(W, i)
                added = True
            else:
                i += 1
    return added


def update_working_set(W: WorkingSet, rx, A, C: Constraint, gfx, J,
                       it: Iteration, eps_rank):
    """WRKSET, enlsip_functions.jl:686-795."""
    F_A = QRP(C.A.T)
    lam = first_lagrange_mult_estimate(C.A, gfx, C.cx, C.scaling,
                                       C.diag_scale, F_A, it, eps_rank)
    s = check_constraint_deletion(W.q, C.A, lam, C.scaling, C.diag_scale,
                                  it.grad_res)
    m, n = J.shape
    p_gn = np.zeros(n)
    if s >= 0:
        cx_s = C.cx[s]
        A_s = C.A[s, :].copy()
        lam_s = lam[s]
        diag_scale_s = C.diag_scale[s]
        index_s = W.active[s]
        lam = np.delete(lam, s)
        C.cx = np.delete(C.cx, s)
        C.diag_scale = np.delete(C.diag_scale, s)
        remove_constraint(W, s)
        it.delete = True
        it.index_del = index_s
        C.A = np.delete(C.A, s, axis=0)
        F_A = QRP(C.A.T)
        rankA = pseudo_rank(F_A.diag(), eps_rank)
        F_L11 = QRP(F_A.R.T)
        p_gn, F_J2 = gn_search_direction(J, rx, C.cx, F_A, F_L11, rankA,
                                         W.t, eps_rank, it)
        # Feasible-direction test (:728): constant false in the mounted
        # source (rankA <= W.t always after deletion).
        As_p = 0.0 if rankA <= W.t else float(np.dot(A_s, p_gn))
        feasible = (As_p >= -cx_s) and (As_p > 0)
        if not feasible:
            C.cx = np.insert(C.cx, s, cx_s)
            lam = np.insert(lam, s, lam_s)
            C.diag_scale = np.insert(C.diag_scale, s, diag_scale_s)
            s_inact = int(np.where(
                W.inactive[: W.l - W.t] == index_s)[0][0])
            add_constraint(W, s_inact)
            it.index_del = -1
            it.delete = False
            act = W.active[: W.t]
            C.A = (A[act, :] * C.diag_scale[:, None] if C.scaling
                   else A[act, :].copy())
            F_A = QRP(C.A.T)
            rankA = pseudo_rank(F_A.diag(), eps_rank)
            F_L11 = QRP(F_A.R.T)
            p_gn, F_J2 = gn_search_direction(J, rx, C.cx, F_A, F_L11,
                                             rankA, W.t, eps_rank, it)
            if not (W.t != rankA or it.rankJ2 != min(m, n - rankA)):
                lam = second_lagrange_mult_estimate(
                    J, F_A, rx, p_gn, W.t, C.scaling, C.diag_scale)
                s2 = check_constraint_deletion(
                    W.q, C.A, lam, C.scaling, C.diag_scale, 0.0)
                if s2 >= 0:
                    index_s2 = W.active[s2]
                    lam = np.delete(lam, s2)
                    C.diag_scale = np.delete(C.diag_scale, s2)
                    C.cx = np.delete(C.cx, s2)
                    remove_constraint(W, s2)
                    it.delete = True
                    it.index_del = index_s2
                    C.A = np.delete(C.A, s2, axis=0)
                    F_A = QRP(C.A.T)
                    rankA = pseudo_rank(F_A.diag(), eps_rank)
                    F_L11 = QRP(F_A.R.T)
                    p_gn, F_J2 = gn_search_direction(
                        J, rx, C.cx, F_A, F_L11, rankA, W.t, eps_rank, it)
    else:
        rankA = pseudo_rank(F_A.diag(), eps_rank)
        F_L11 = QRP(F_A.R.T)
        p_gn, F_J2 = gn_search_direction(J, rx, C.cx, F_A, F_L11, rankA,
                                         W.t, eps_rank, it)
        if not (W.t != rankA or it.rankJ2 != min(m, n - rankA)):
            lam = second_lagrange_mult_estimate(
                J, F_A, rx, p_gn, W.t, C.scaling, C.diag_scale)
            s2 = check_constraint_deletion(
                W.q, C.A, lam, C.scaling, C.diag_scale, 0.0)
            if s2 >= 0:
                index_s2 = W.active[s2]
                lam = np.delete(lam, s2)
                C.diag_scale = np.delete(C.diag_scale, s2)
                C.cx = np.delete(C.cx, s2)
                remove_constraint(W, s2)
                it.delete = True
                it.index_del = index_s2
                C.A = np.delete(C.A, s2, axis=0)
                F_A = QRP(C.A.T)
                rankA = pseudo_rank(F_A.diag(), eps_rank)
                F_L11 = QRP(F_A.R.T)
                p_gn, F_J2 = gn_search_direction(
                    J, rx, C.cx, F_A, F_L11, rankA, W.t, eps_rank, it)
    it.lam = lam
    return F_A, F_L11, F_J2, p_gn


def init_working_set(cx, K: List[np.ndarray], step: Iteration, q, l):
    """INIALC, enlsip_functions.jl:826-859."""
    delta, eps_w = 0.1, 0.01
    for i in range(len(K)):
        K[i] = delta * np.ones(l)
    for i in range(l):
        step.w[i] = min(abs(cx[i]) + eps_w, delta)
    active = -np.ones(l, dtype=int)
    inactive = -np.ones(l - q, dtype=int)
    t = q
    lmt = 0
    active[:q] = np.arange(q)
    for i in range(q, l):
        if cx[i] <= 0.0:
            active[t] = i
            t += 1
        else:
            inactive[lmt] = i
            lmt += 1
    step.t = t
    return WorkingSet(q, t, l, active, inactive)


def subspace_min_previous_step(tau, rho, rho_prk, c1, pseudo_rk,
                               previous_dimR, progress,
                               predicted_linear_progress,
                               prelin_previous_dim, previous_alpha):
    """PRESUB, enlsip_functions.jl:864-904 (1-based dims kept as counts)."""
    stepb, pgb1, pgb2, predb, rlenb, c2 = 2e-1, 3e-1, 1e-1, 7e-1, 2.0, 1e2
    if (previous_alpha < stepb
            and progress <= pgb1 * predicted_linear_progress ** 2
            and progress <= pgb2 * prelin_previous_dim ** 2):
        dim = max(1, previous_dimR - 1)
        if previous_dimR > 1 and rho[dim - 1] > c1 * rho_prk:
            return dim
    dim = previous_dimR
    if previous_dimR < len(tau) and (
            (rho[dim - 1] > predb * rho_prk
             and rlenb * tau[dim - 1] < tau[dim])
            or c2 * tau[dim - 1] < tau[dim]):
        suggested_dim = dim
    else:
        i1 = previous_dimR - 1
        if i1 <= 0:
            suggested_dim = pseudo_rk
        else:
            buff = [i for i in range(i1, previous_dimR + 1)
                    if rho[i - 1] > predb * rho_prk]
            suggested_dim = min(buff) if buff else pseudo_rk
    return suggested_dim


def gn_previous_step(tau, tau_prk, mindim, rho, rho_prk, prank):
    """PREGN, enlsip_functions.jl:909-932 (dims are 1-based counts)."""
    tau_max, rho_min = 2e-1, 5e-1
    pm1 = prank - 1
    if mindim > pm1:
        return mindim
    k = pm1
    while (tau[k - 1] >= tau_max * tau_prk
           or rho[k - 1] <= rho_min * rho_prk) and k > mindim:
        k -= 1
    return k if k > mindim else max(mindim, pm1)


def check_gn_direction(b1nrm, d1nrm, d1nrm_as_km1, dnrm, active_c_sum,
                       iter_number, rankA, n, m, restart,
                       constraint_added, constraint_deleted,
                       W: WorkingSet, cx, lam, iter_km1: Iteration,
                       scaling, diag_scale):
    """GNDCHK, enlsip_functions.jl:943-1030."""
    delta = 1e-1
    c1, c2, c3, c4, c5 = 0.5, 0.1, 4.0, 10.0, 0.05
    eps_rel = np.finfo(float).eps
    beta_k = math.sqrt(d1nrm ** 2 + b1nrm ** 2)
    method_code = 1
    newton_or_restart = iter_km1.code == 2 or restart
    first_iter = iter_number == 0
    submin_prev_iter = iter_km1.code == -1
    add_or_del = constraint_added or constraint_deleted
    convergence_lower_c1 = beta_k < c1 * iter_km1.beta
    progress_not_close = (iter_km1.progress > c2 * iter_km1.predicted_reduction
                          and dnrm <= c3 * beta_k)
    if newton_or_restart or (not first_iter and (
            submin_prev_iter or not (add_or_del or convergence_lower_c1
                                     or progress_not_close))):
        method_code = -1
        non_linearity_k = math.sqrt(d1nrm * d1nrm + active_c_sum)
        non_linearity_km1 = math.sqrt(d1nrm_as_km1 * d1nrm_as_km1
                                      + active_c_sum)
        to_reduce = False
        if W.q < W.t:
            sqr_eps = math.sqrt(np.finfo(float).eps)
            rows = np.array([(1.0 / diag_scale[i]) if scaling
                             else diag_scale[i]
                             for i in range(W.q, W.t)])
            lam_seg = lam[W.q:W.t]
            lagrange_mult_cond = (np.any(lam_seg * rows >= -sqr_eps)
                                  and np.any(lam_seg < 0))
            to_reduce = to_reduce or bool(lagrange_mult_cond)
        if W.l - W.t > 0:
            inact_c = np.array([cx[W.inactive[j]]
                                for j in range(W.l - W.t)])
            to_reduce = to_reduce or bool(np.any(inact_c < delta))
        newton_previously = iter_km1.code == 2 and not constraint_deleted
        cond4 = active_c_sum > c2
        cond5 = (constraint_deleted or constraint_added or to_reduce
                 or (W.t == n and W.t == rankA))
        eps6 = max(1e-2, 10.0 * eps_rel)
        cond6 = (not ((W.l == W.q) or (rankA <= W.t))
                 and not ((beta_k < eps6 * dnrm)
                          or (b1nrm < eps6 and m == n - W.t)))
        if newton_previously or not (cond4 or cond5 or cond6):
            cond7 = ((iter_km1.alpha < c5
                      and non_linearity_km1 < c2 * non_linearity_k)
                     or m == n - W.t)
            cond8 = not (dnrm <= c4 * beta_k)
            if newton_previously or cond7 or cond8:
                method_code = 2
    return method_code, beta_k


def determine_solving_dim(previous_dimR, rankR, predicted_linear_progress,
                          obj_progress, prelin_previous_dim, R, y,
                          previous_alpha, restart):
    """DIMUPP, enlsip_functions.jl:1041-1113."""
    c1 = 0.1
    newdim = rankR
    eta = 1.0
    mindim = 1
    if rankR > 0:
        l_sd = np.zeros(rankR)
        l_rh = np.zeros(rankR)
        l_sd[0] = abs(y[0])
        l_rh[0] = abs(y[0] / R[0, 0])
        for i in range(1, rankR):
            si = y[i]
            ri = y[i] / R[i, i]
            l_rh[i] = math.hypot(l_rh[i - 1], ri)
            l_sd[i] = math.hypot(l_sd[i - 1], si)
        nrm_sd = l_sd[rankR - 1]
        nrm_rh = l_rh[rankR - 1]
        dsum = 0.0
        psimax = 0.0
        for i in range(rankR):
            dsum += l_sd[i] ** 2
            psi_v = math.sqrt(dsum) * abs(R[i, i])
            if psi_v > psimax:
                psimax = psi_v
                mindim = i + 1
        if not restart:
            if previous_dimR == rankR or previous_dimR <= 0:
                suggested = gn_previous_step(l_sd, nrm_sd, mindim, l_rh,
                                             nrm_rh, rankR)
            else:
                suggested = subspace_min_previous_step(
                    l_sd, l_rh, nrm_rh, c1, rankR, previous_dimR,
                    obj_progress, predicted_linear_progress,
                    prelin_previous_dim, previous_alpha)
            newdim = max(mindim, suggested)
        else:
            newdim = max(0, min(rankR, previous_dimR))
            if newdim != 0:
                k = max(previous_dimR - 1, 1)
                if l_sd[newdim - 1] != 0:
                    eta = l_sd[k - 1] / l_sd[newdim - 1]
    return newdim, eta


def _prefix_norm(v, k):
    """ORACLE-GUARD: clamped prefix norm (reference indexes v[1:k] and
    would throw for k > len(v); production repairs this — SUBSPC clamps)."""
    k = max(0, min(int(k), len(v)))
    return float(np.linalg.norm(v[:k]))


def choose_subspace_dimensions(rx_sum, rx, active_cx_sum, J1, t, rankJ2,
                               rankA, b, F_L11: QRP, F_J2: QRP,
                               prev: Iteration, restart):
    """SUBSPC, enlsip_functions.jl:1118-1176."""
    c1, c2, alpha_low = 0.1, 0.01, 0.2
    previous_alpha = prev.alpha
    if rankA <= 0:
        dimA = 0
        previous_dimA = 0
        d = -rx
    else:
        previous_dimA = abs(prev.dimA) + t - prev.t
        nrm_b_asprev = _prefix_norm(b, previous_dimA)
        nrm_b = float(np.linalg.norm(b))
        constraint_progress = float(np.dot(prev.cx, prev.cx)) - active_cx_sum
        dimA, _ = determine_solving_dim(previous_dimA, rankA, nrm_b,
                                        constraint_progress, nrm_b_asprev,
                                        F_L11.R, b, previous_alpha, restart)
        dp1 = _usolve(F_L11.R[:dimA, :dimA], b[:dimA])
        p1 = F_L11.perm_matrix()[:rankA, :rankA] @ np.concatenate(
            [dp1, np.zeros(rankA - dimA)])
        d = -(rx + J1 @ p1)
    if rankJ2 > 0:
        d = F_J2.Q.T @ d
    previous_dimJ2 = abs(prev.dimJ2) + prev.t - t
    nrm_d_asprev = _prefix_norm(d, previous_dimJ2)
    nrm_d = float(np.linalg.norm(d))
    residual_progress = float(np.dot(prev.rx, prev.rx)) - rx_sum
    dimJ2, _ = determine_solving_dim(previous_dimJ2, rankJ2, nrm_d,
                                     residual_progress, nrm_d_asprev,
                                     F_J2.R, d, previous_alpha, restart)
    if not restart and previous_alpha >= alpha_low:
        dimA = max(dimA, previous_dimA)
        dimJ2 = max(dimJ2, previous_dimJ2)
    return dimA, dimJ2


def search_direction_analys(prev: Iteration, it: Iteration, iter_number,
                            x, fns: Fns, rx, cx, active_C: Constraint,
                            active_cx_sum, p_gn, J, W: WorkingSet,
                            F_A: QRP, F_L11, F_J2: QRP,
                            second_derivatives):
    """ANALYS, enlsip_functions.jl:1191-1291."""
    m, n = J.shape
    rx_sum = float(np.dot(rx, rx))
    active_cx = active_C.cx
    lam = it.lam
    b_gn = it.b_gn
    nrm_b1_gn = _prefix_norm(b_gn, it.dimA)
    rankA = it.rankA
    d_gn = it.d_gn
    nrm_d_gn = float(np.linalg.norm(d_gn))
    nrm_d1_gn = _prefix_norm(d_gn, it.dimJ2)
    rankJ2 = it.rankJ2
    prev_dimJ2m1 = prev.dimJ2 + prev.t - W.t - 1
    nrm_d1_asprev = _prefix_norm(d_gn, prev_dimJ2m1)
    restart = it.restart
    error_code = 0
    method_code, beta = check_gn_direction(
        nrm_b1_gn, nrm_d1_gn, nrm_d1_asprev, nrm_d_gn, active_cx_sum,
        iter_number, rankA, n, m, restart, it.add, it.delete, W, cx, lam,
        prev, active_C.scaling, active_C.diag_scale)
    if method_code == 1:
        dimA = rankA
        dimJ2 = rankJ2
        p, b, d = p_gn, b_gn, d_gn
    elif method_code == -1:
        JQ1 = J @ F_A.Q
        J1 = JQ1[:, :rankA]
        b = F_L11.Q.T @ (-active_cx[F_A.p])
        dimA, dimJ2 = choose_subspace_dimensions(
            rx_sum, rx, active_cx_sum, J1, W.t, rankJ2, rankA, b, F_L11,
            F_J2, prev, restart)
        p, b, d = sub_search_direction(J1, rx, active_cx, F_A, F_L11,
                                       F_J2, n, W.t, rankA, dimA, dimJ2,
                                       -1)
        if dimA == rankA and dimJ2 == rankJ2:
            method_code = 1
    else:  # method_code == 2
        if second_derivatives:
            p, newton_error = newton_search_direction(
                fns, x, active_cx, W, lam, rx, J, F_A, F_L11, rankA)
            b, d = b_gn, d_gn
            dimA = -W.t
            dimJ2 = W.t - n
            it.nb_newton_steps += 1
            if newton_error:
                error_code = -3
        else:
            p, b, d = p_gn, b_gn, d_gn
            dimA, dimJ2 = rankA, rankJ2
            error_code = -4
    it.b_gn = b
    it.d_gn = d
    it.dimA = dimA
    it.dimJ2 = dimJ2
    it.code = method_code
    it.speed = beta / prev.beta if prev.beta != 0 else math.inf
    it.beta = beta
    it.p = p
    return error_code


# ------------------------------------------------- merit / linesearch

def psi(x, alpha, p, fns: Fns, w, m, l, t, active, inactive):
    """psi, enlsip_functions.jl:1307-1340."""
    x_new = x + alpha * p
    rxb = fns.res(x_new)
    cxb = fns.cons(x_new)
    pen = 0.0
    for i in range(t):
        j = active[i]
        pen += w[j] * cxb[j] ** 2
    for i in range(l - t):
        j = inactive[i]
        if cxb[j] < 0.0:
            pen += w[j] * cxb[j] ** 2
    return 0.5 * (float(np.dot(rxb, rxb)) + pen)


def assort(K, w, t, active):
    """ASSORT, enlsip_functions.jl:1344-1360."""
    for i in range(t):
        k = active[i]
        for ii in range(4):
            if w[k] > K[ii][k]:
                for j in range(3, ii, -1):
                    K[j][k] = K[j - 1][k]
                K[ii][k] = w[k]
                break


def min_norm_w(ctrl, w, w_old, y, tau, pos_index, nb_pos):
    """EUCMOD, enlsip_functions.jl:1374-1423 (w modified in place)."""
    w[:] = w_old
    if nb_pos > 0:
        y = y.copy()
        pos_index = list(pos_index)
        y_sum = float(np.dot(y, y))
        y_norm = float(np.linalg.norm(y))
        if y_norm != 0.0:
            y /= y_norm
        tau_new = tau
        s = 0.0
        n_runch = nb_pos
        eps_rel = np.finfo(float).eps
        while True:
            tau_new -= s
            c = 1.0 if np.max(np.abs(y)) <= eps_rel else tau_new / y_sum
            y_sum, s = 0.0, 0.0
            i_stop = n_runch
            k = 0
            while k < n_runch:
                i = pos_index[k]
                buff = c * y[k] * y_norm
                if buff >= w_old[i]:
                    w[i] = buff
                    y_sum += y[k] ** 2
                    k += 1
                else:
                    s += w_old[i] * y[k] * y_norm
                    n_runch -= 1
                    for j in range(k, n_runch):
                        pos_index[j] = pos_index[j + 1]
                        y[j] = y[j + 1]
            y_sum *= y_norm * y_norm
            if (n_runch <= 0) or (ctrl == 2) or (i_stop == n_runch):
                break


def euclidean_norm_weight_update(vA, cx, active, t, mu, dimA,
                                 previous_w, K):
    """EUCNRM, enlsip_functions.jl:1429-1497."""
    w = previous_w.copy()
    if t != 0:
        z = vA ** 2
        w_old = K[3]
        ztw = float(np.dot(z, w_old[active[:t]]))
        if ztw >= mu and dimA < t:
            y = np.zeros(t)
            pos_index = np.zeros(t, dtype=int)
            nb_pos, gamma = 0, 0.0
            for i in range(t):
                k = active[i]
                y_elem = vA[i] * (vA[i] + cx[k])
                if y_elem > 0:
                    pos_index[nb_pos] = k
                    y[nb_pos] = y_elem
                    nb_pos += 1
                else:
                    gamma -= y_elem * w_old[k]
            min_norm_w(2, w, w_old, y, gamma, pos_index, nb_pos)
        elif ztw < mu and dimA < t:
            e = np.zeros(t)
            pos_index = np.zeros(t, dtype=int)
            nb_pos, tau = 0, mu
            for i in range(t):
                k = active[i]
                e_elem = -vA[i] * cx[k]
                if e_elem > 0:
                    pos_index[nb_pos] = k
                    e[nb_pos] = e_elem
                    nb_pos += 1
                else:
                    tau -= e_elem * w_old[k]
            min_norm_w(2, w, w_old, e, tau, pos_index, nb_pos)
        elif ztw < mu and dimA == t:
            pos_index = np.array(active[:t], dtype=int)
            min_norm_w(1, w, w_old, z.copy(), mu, pos_index, t)
        assort(K, w, t, active)
    return w


def max_norm_weight_update(nrm_Ap, rmy, alpha_w, delta, w, active, t, K):
    """MAXNRM, enlsip_functions.jl:1504-1539."""
    mu = 0.0 if abs(alpha_w - 1.0) <= delta else rmy / nrm_Ap
    i1 = active[0] if active[0] >= 0 else 0
    previous_w = w[i1]
    nu = max(mu, K[3][0])
    for i in range(t):
        w[active[i]] = nu
    if mu > previous_w:
        for i in range(4):
            if mu > K[i][0]:
                for j in range(3, i, -1):
                    K[j][0] = K[j - 1][0]
                K[i][0] = mu
                break


def penalty_weight_update(w_old, Jp, Ap, K, rx, cx, W: WorkingSet,
                          dimA, norm_code):
    """WEIGHT, enlsip_functions.jl:1545-1628."""
    delta = 0.25
    active = W.active
    t = W.t
    Jp = Jp.copy(); Ap = Ap.copy(); rx = rx.copy(); cx = cx.copy()
    nrm_Ap = math.sqrt(float(np.dot(Ap, Ap)))
    sel = cx[active[:dimA]] if dimA > 0 else np.zeros(0)
    nrm_cx = 0.0 if sel.size == 0 else max(0.0, float(np.max(np.abs(sel))))
    nrm_Jp = math.sqrt(float(np.dot(Jp, Jp)))
    nrm_rx = math.sqrt(float(np.dot(rx, rx)))
    if nrm_Jp != 0:
        Jp = Jp / nrm_Jp
    if nrm_Ap != 0:
        Ap = Ap / nrm_Ap
    if nrm_rx != 0:
        rx = rx / nrm_rx
    if nrm_cx != 0:
        cx = cx / nrm_cx
    Jp_rx = float(np.dot(Jp, rx)) * nrm_Jp * nrm_rx
    AtwA = 0.0
    BtwA = 0.0
    if dimA > 0:
        for i in range(dimA):
            k = active[i]
            AtwA += w_old[k] * Ap[i] ** 2
            BtwA += w_old[k] * Ap[i] * cx[k]
    AtwA *= nrm_Ap ** 2
    BtwA *= nrm_Ap * nrm_cx
    alpha_w = 1.0
    if abs(AtwA + nrm_Jp ** 2) > np.finfo(float).eps:
        alpha_w = (-BtwA - Jp_rx) / (AtwA + nrm_Jp ** 2)
    rmy = (abs(Jp_rx + nrm_Jp ** 2) / delta) - nrm_Jp ** 2
    if norm_code == 0:
        w = w_old.copy()
        max_norm_weight_update(nrm_Ap, rmy, alpha_w, delta, w, active, t, K)
    else:  # norm_code == 2
        w = euclidean_norm_weight_update(Ap * nrm_Ap, cx * nrm_cx,
                                         active, t, rmy, dimA, w_old, K)
    BtwA = 0.0
    AtwA = 0.0
    for i in range(t):
        k = active[i]
        AtwA += w[k] * Ap[i] ** 2
        BtwA += w[k] * Ap[i] * cx[k]
    BtwA *= nrm_Ap * nrm_cx
    AtwA *= nrm_Ap ** 2
    dpsi0 = BtwA + Jp_rx
    return w, dpsi0


def concatenate(v, rx, cx, w, m, t, l, active, inactive):
    """CONCAT, enlsip_functions.jl:1635-1659."""
    v[:m] = rx
    for i in range(t):
        k = active[i]
        v[m + k] = math.sqrt(w[k]) * cx[k]
    for j in range(l - t):
        k = inactive[j]
        v[m + k] = 0.0 if cx[k] > 0 else math.sqrt(w[k]) * cx[k]


def coefficients_linesearch(v0, v1, v2, alpha_k, rx, cx, rx_new, cx_new,
                            w, m, t, l, active, inactive):
    """LINC2, enlsip_functions.jl:1665-1689."""
    concatenate(v0, rx, cx, w, m, t, l, active, inactive)
    v_buff = np.zeros(m + l)
    concatenate(v_buff, rx_new, cx_new, w, m, t, l, active, inactive)
    v2[:] = ((v_buff - v0) / alpha_k - v1) / alpha_k


def minimize_quadratic(x1, y1, x2, y2, x3, y3):
    """QUAMIN, enlsip_functions.jl:1694-1701."""
    d1, d2 = y2 - y1, y3 - y1
    s = (x3 - x1) ** 2 * d1 - (x2 - x1) ** 2 * d2
    q = 2 * ((x2 - x1) * d2 - (x3 - x1) * d1)
    return x1 - s / q


def minrn(x1, y1, x2, y2, x3, y3, alpha_min, alpha_max, p_max):
    """MINRN, enlsip_functions.jl:1708-1735."""
    eps = math.sqrt(np.finfo(float).eps) / p_max
    if abs(x1 - x2) < eps or abs(x3 - x1) < eps or abs(x3 - x2) < eps:
        return 0.0, 0.0
    u = minimize_quadratic(x1, y1, x2, y2, x3, y3)
    alpha = min(max(u, alpha_min), alpha_max)
    t1 = (alpha - x1) * (alpha - x2) * y3 / ((x3 - x1) * (x3 - x2))
    t2 = (alpha - x3) * (alpha - x2) * y1 / ((x1 - x3) * (x1 - x2))
    t3 = (alpha - x3) * (alpha - x2) * y2 / ((x2 - x1) * (x2 - x3))
    return alpha, t1 + t2 + t3


class Poly:
    """Ascending-coefficient polynomial (stand-in for Polynomials.jl)."""

    def __init__(self, coeffs):
        self.c = np.asarray(coeffs, float)

    def __call__(self, x):
        return float(np.polyval(self.c[::-1], x))

    def deriv(self):
        n = len(self.c)
        return Poly([self.c[i] * i for i in range(1, n)])


def parameters_rm(v0, v1, v2, x_min, ds: Poly, dds: Poly):
    """enlsip_functions.jl:1739-1783."""
    dds_best = dds(x_min)
    eta, d = 0.1, 1.0
    normv2 = float(np.dot(v2, v2))
    h0 = abs(ds(x_min) / dds_best)
    Dm = (abs(6 * float(np.dot(v1, v2)) + 12 * x_min * normv2)
          + 24 * h0 * normv2)
    hm = max(h0, 1.0)
    beta_hat = None
    if dds_best * eta < 2 * Dm * hm:
        a3, a2, a1 = (ds.c / (2 * normv2))[::-1][:3]  # see below
        # ds has coeffs [c0, c1, c2, c3] ascending; Julia coeffs(ds)
        # returns ascending and the tuple unpack takes (a3,a2,a1) =
        # (c0, c1, c2) / (2 normv2) -- i.e. a3 is the CONSTANT term.
        c0, c1, c2 = ds.c[0], ds.c[1], ds.c[2]
        a3, a2, a1 = (np.array([c0, c1, c2]) / (2 * normv2))
        b = a2 - (a1 ** 2) / 3
        c = a3 - a1 * a2 / 3 + 2 * (a1 / 3) ** 3
        d = (c / 2) ** 2 + (b / 3) ** 3
        if d < 0:
            alpha_hat, beta_hat = two_roots(b, c, d, a1, x_min)
        else:
            alpha_hat = one_root(c, d, a1)
    else:
        alpha_hat = newton_raphson(x_min, Dm, ds, dds)
    if d >= 0:
        beta_hat = alpha_hat
    return alpha_hat, beta_hat


def bounds_fn(alpha_min, alpha_max, alpha, s: Poly):
    """enlsip_functions.jl:1785-1789."""
    alpha = min(alpha, alpha_max)
    alpha = max(alpha, alpha_min)
    return alpha, s(alpha)


def newton_raphson(x_min, Dm, ds: Poly, dds: Poly):
    """enlsip_functions.jl:1791-1811."""
    alpha, it = x_min, 0
    eps, error = 1e-4, 1.0
    while (error > eps or it < 3) and it < 50:
        c = dds(alpha)
        if abs(c) < np.finfo(float).eps:
            break
        h = -ds(alpha) / c
        alpha += h
        error = (2 * Dm * h ** 2) / abs(c)
        it += 1
    return alpha


def one_root(c, d, a):
    """ONER, enlsip_functions.jl:1815-1818."""
    arg1, arg2 = -c / 2 + math.sqrt(d), -c / 2 - math.sqrt(d)
    return np.cbrt(arg1) + np.cbrt(arg2) - a / 3


def two_roots(b, c, d, a, x_min):
    """TWOR, enlsip_functions.jl:1821-1837."""
    phi = math.acos(abs(c / 2) / (-b / 3) ** 1.5)
    t = 2 * math.sqrt(-b / 3) if c <= 0 else -2 * math.sqrt(-b / 3)
    b1 = t * math.cos(phi / 3) - a / 3
    b2 = t * math.cos((phi + 2 * math.pi) / 3) - a / 3
    b3 = t * math.cos((phi + 4 * math.pi) / 3) - a / 3
    b1, b2, b3 = sorted([b1, b2, b3])
    return (b1, b3) if x_min <= b2 else (b3, b1)


def minrm_fn(v0, v1, v2, x_min, alpha_min, alpha_max):
    """MINRM, enlsip_functions.jl:1841-1862."""
    s = Poly([0.5 * float(np.dot(v0, v0)), float(np.dot(v0, v1)),
              float(np.dot(v0, v2)) + 0.5 * float(np.dot(v1, v1)),
              float(np.dot(v1, v2)), 0.5 * float(np.dot(v2, v2))])
    ds = s.deriv()
    dds = ds.deriv()
    alpha_hat, beta_hat = parameters_rm(v0, v1, v2, x_min, ds, dds)
    s_alpha, s_beta = s(alpha_hat), s(beta_hat)
    alpha_old = alpha_hat
    alpha_hat, s_alpha = bounds_fn(alpha_min, alpha_max, alpha_hat, s)
    if alpha_old == beta_hat:
        beta_hat, s_beta = alpha_hat, s(alpha_hat)
    else:
        beta_hat, s_beta = bounds_fn(alpha_min, alpha_max, beta_hat, s)
    return alpha_hat, s_alpha, beta_hat, s_beta


def check_reduction(psi_alpha, psi_k, approx_k, eta, diff_psi):
    """REDC, enlsip_functions.jl:1870-1886."""
    delta = 0.2
    if psi_alpha - approx_k >= eta * diff_psi:
        return not ((psi_alpha - psi_k < eta * diff_psi)
                    and (psi_k > delta * psi_alpha))
    return False


def goldstein_armijo_step(psi0, dpsi0, alpha_min, tau, p_max, x, alpha0,
                          p, fns: Fns, w, m, l, t, active, inactive):
    """GAC, enlsip_functions.jl:1893-1923."""
    u = alpha0
    sqr_eps = math.sqrt(np.finfo(float).eps)
    exit = (p_max * u < sqr_eps) or (u <= alpha_min)
    psi_u = psi(x, u, p, fns, w, m, l, t, active, inactive)
    while not exit and (psi_u > psi0 + tau * u * dpsi0):
        u *= 0.5
        psi_u = psi(x, u, p, fns, w, m, l, t, active, inactive)
        exit = (p_max * u < sqr_eps) or (u <= alpha_min)
    return u, exit


def linesearch_constrained(x, alpha0, p, fns: Fns, rx, cx, JpAp, w,
                           W: WorkingSet, psi0, dpsi0, alpha_low,
                           alpha_upp):
    """LINEC, enlsip_functions.jl:1940-2143."""
    m = len(rx)
    l, t = W.l, W.t
    active, inactive = W.active, W.inactive
    eta, tau, gamma = 0.3, 0.25, 0.4
    alpha_min, alpha_max = alpha_low, alpha_upp
    alpha_k = min(alpha0, alpha_max)
    alpha_km1 = 0.0
    psi_km1 = psi0
    p_max = float(np.max(np.abs(p)))
    gac_error = False
    v1 = JpAp.copy()
    for i in range(t):
        k = active[i]
        v1[m + k] = math.sqrt(w[k]) * v1[m + k]
    for j in range(l - t):
        k = inactive[j]
        v1[m + k] = 0.0 if cx[k] > 0 else math.sqrt(w[k]) * v1[m + k]
    psi_k = psi(x, alpha_k, p, fns, w, m, l, t, active, inactive)
    diff_psi = psi0 - psi_k
    x_new = x + alpha_k * p
    rx_new = fns.res(x_new)
    cx_new = fns.cons(x_new)
    v0 = np.zeros(m + l)
    v2 = np.zeros(m + l)
    coefficients_linesearch(v0, v1, v2, alpha_k, rx, cx, rx_new, cx_new,
                            w, m, t, l, active, inactive)
    x_min = alpha_k if diff_psi >= 0 else 0.0
    alpha_kp1, pk, beta, pbeta = minrm_fn(v0, v1, v2, x_min, alpha_min,
                                          alpha_max)
    if alpha_kp1 != beta and pbeta < pk and beta <= alpha_k:
        alpha_kp1 = beta
        pk = pbeta
    alpha_km2 = alpha_km1
    psi_km2 = psi_km1
    alpha_km1 = alpha_k
    psi_km1 = psi_k
    alpha_k = alpha_kp1
    psi_k = psi(x, alpha_k, p, fns, w, m, l, t, active, inactive)
    if (-diff_psi <= tau * dpsi0 * alpha_km1) or (psi_km1 < gamma * psi0):
        diff_psi = psi0 - psi_k
        reduction_likely = check_reduction(psi_km1, psi_k, pk, eta,
                                           diff_psi)
        while reduction_likely:
            alpha_kp1, pk = minrn(alpha_k, psi_k, alpha_km1, psi_km1,
                                  alpha_km2, psi_km2, alpha_min,
                                  alpha_max, p_max)
            alpha_km2 = alpha_km1
            psi_km2 = psi_km1
            alpha_km1 = alpha_k
            psi_km1 = psi_k
            alpha_k = alpha_kp1
            psi_k = psi(x, alpha_k, p, fns, w, m, l, t, active, inactive)
            diff_psi = psi0 - psi_k
            reduction_likely = check_reduction(psi_km1, psi_k, pk, eta,
                                               diff_psi)
        if (psi_km1 - pk >= eta * diff_psi) and (psi_k < psi_km1):
            alpha_km1 = alpha_k
            psi_km1 = psi_k
    else:
        diff_psi = psi0 - psi_k
        if (-diff_psi <= tau * dpsi0 * alpha_k) or (psi_k < gamma * psi0):
            if psi0 <= psi_km1:
                x_min = alpha_k
                x_new = x + alpha_k * p
                rx_new = fns.res(x_new)
                cx_new = fns.cons(x_new)
                v0[:] = 0.0
                v2[:] = 0.0
                coefficients_linesearch(v0, v1, v2, alpha_k, rx, cx,
                                        rx_new, cx_new, w, m, t, l,
                                        active, inactive)
                alpha_kp1, pk, beta, pbeta = minrm_fn(
                    v0, v1, v2, x_min, alpha_min, alpha_max)
                if alpha_kp1 != beta and pbeta < pk and beta <= alpha_k:
                    alpha_kp1 = beta
                    pk = pbeta
                alpha_km1 = 0.0
                psi_km1 = psi0
            else:
                alpha_kp1, pk = minrn(alpha_k, psi_k, alpha_km1, psi_km1,
                                      alpha_km2, psi_km2, alpha_min,
                                      alpha_max, p_max)
            alpha_km2 = alpha_km1
            psi_km2 = psi_km1
            alpha_km1 = alpha_k
            psi_km1 = psi_k
            alpha_k = alpha_kp1
            psi_k = psi(x, alpha_k, p, fns, w, m, l, t, active, inactive)
            reduction_likely = check_reduction(psi_km1, psi_k, pk, eta,
                                               diff_psi)
            while reduction_likely:
                alpha_kp1, pk = minrn(alpha_k, psi_k, alpha_km1, psi_km1,
                                      alpha_km2, psi_km2, alpha_min,
                                      alpha_max, p_max)
                alpha_km2 = alpha_km1
                psi_km2 = psi_km1
                alpha_km1 = alpha_k
                psi_km1 = psi_k
                alpha_k = alpha_kp1
                psi_k = psi(x, alpha_k, p, fns, w, m, l, t, active,
                            inactive)
                reduction_likely = check_reduction(psi_km1, psi_k, pk,
                                                   eta, diff_psi)
            if (psi_km1 - pk >= eta * diff_psi) and (psi_k < psi_km1):
                alpha_km1 = alpha_k
                psi_km1 = psi_k
        else:
            alpha_km1, gac_error = goldstein_armijo_step(
                psi0, dpsi0, alpha_min, tau, p_max, x, alpha_k, p, fns,
                w, m, l, t, active, inactive)
    return alpha_km1, gac_error


def upper_bound_steplength(A, cx, p, W: WorkingSet, index_del):
    """UPBND, enlsip_functions.jl:2149-2178. index_del -1 = none."""
    alpha_upper = math.inf
    index_alpha_upp = -1
    if np.any(W.inactive[: max(W.l - W.t, 0)] >= 0):
        for i in range(W.l - W.t):
            j = W.inactive[i]
            if j != index_del:
                gcjTp = float(np.dot(A[j, :], p))
                with np.errstate(divide="ignore", invalid="ignore"):
                    alpha_j = -cx[j] / gcjTp if gcjTp != 0 else math.inf
                if cx[j] > 0 and gcjTp < 0 and alpha_j < alpha_upper:
                    alpha_upper = alpha_j
                    index_alpha_upp = j
    return min(3.0, alpha_upper), index_alpha_upp


def compute_steplength(it: Iteration, prev: Iteration, x, fns: Fns, rx,
                       J, cx, A, active_constraint: Constraint,
                       W: WorkingSet, K, weight_code):
    """STPLNG, enlsip_functions.jl:2197-2293."""
    m = J.shape[0]
    p = it.p
    dimA = it.dimA
    rankJ2 = it.rankJ2
    method_code = it.code
    ind_del = it.index_del
    previous_alpha = prev.alpha
    prev_rankJ2 = prev.rankJ2
    w_old = prev.w
    Jp = J @ p
    Ap = A @ p
    JpAp = np.concatenate([Jp, Ap])
    active_Ap = active_constraint.A @ p
    if active_constraint.scaling:
        active_Ap = active_Ap / active_constraint.diag_scale
    active_index = W.active[: W.t]
    psi_error = 0
    if method_code != 2:
        w, dpsi0 = penalty_weight_update(w_old, Jp, active_Ap, K, rx, cx,
                                         W, dimA, weight_code)
        psi0 = 0.5 * (float(np.dot(rx, rx))
                      + float(np.dot(w[active_index],
                                     cx[active_index] ** 2)))
        if dpsi0 >= 0:
            alpha = 1.0
            psi_error = -1
            it.index_alpha_upp = -1
        else:
            alpha_upp, index_alpha_upp = upper_bound_steplength(
                A, cx, p, W, ind_del)
            alpha_low = alpha_upp / 3000.0
            magfy = 6.0 if rankJ2 < prev_rankJ2 else 3.0
            alpha0 = min(1.0, magfy * previous_alpha, alpha_upp)
            alpha, gac_error = linesearch_constrained(
                x, alpha0, p, fns, rx, cx, JpAp, w, W, psi0, dpsi0,
                alpha_low, alpha_upp)
            if gac_error:
                psi_k = psi(x, alpha, p, fns, w, m, W.l, W.t, W.active,
                            W.inactive)
                psi_error = check_derivatives(dpsi0, psi0, psi_k, x,
                                              alpha, p, fns, w, W, m)
            uppbound = min(1.0, alpha_upp)
            atwa = float(np.dot(w[active_index], active_Ap ** 2))
            it.predicted_reduction = uppbound * (
                -2.0 * float(np.dot(Jp, rx))
                - uppbound * float(np.dot(Jp, Jp))
                + (2.0 - uppbound ** 2) * atwa)
            x_new = x + alpha * p
            rx_new = fns.res(x_new)
            cx_new = fns.cons(x_new)
            whsum = float(np.dot(w[active_index],
                                 cx_new[active_index] ** 2))
            it.progress = 2 * psi0 - float(np.dot(rx_new, rx_new)) - whsum
            it.index_alpha_upp = (
                -1 if (index_alpha_upp >= 0
                       and abs(alpha - alpha_upp) > 0.1)
                else index_alpha_upp)
    else:
        w = w_old.copy()
        it.index_alpha_upp = -1
        alpha = 1.0
    return alpha, w, psi_error


def check_derivatives(dpsi0, psi0, psi_k, x_old, alpha, p, fns: Fns, w,
                      W: WorkingSet, m):
    """enlsip_functions.jl:2295-2322."""
    l, t = W.l, W.t
    psi_ma = psi(x_old, -alpha, p, fns, w, m, l, t, W.active, W.inactive)
    dpsi_fwd = (psi_k - psi0) / alpha
    dpsi_bwd = (psi0 - psi_ma) / alpha
    dpsi_ctr = (psi_k - psi_ma) / (2 * alpha)
    max_diff = max(abs(dpsi_fwd - dpsi_ctr), abs(dpsi_fwd - dpsi_bwd),
                   abs(dpsi_bwd - dpsi_ctr))
    inconsistency = (abs(dpsi_fwd - dpsi0) > max_diff
                     and abs(dpsi_ctr - dpsi0) > max_diff)
    return -1 if inconsistency else 0


def check_termination_criteria(it: Iteration, prev: Iteration,
                               W: WorkingSet, active_C: Constraint, x,
                               cx, rx_sum, gfx, max_iter, nb_iter,
                               eps_abs, eps_rel, eps_x, eps_c,
                               error_code, delta_time, sigma_min,
                               lam_abs_max, psi_error):
    """TERCRI, enlsip_functions.jl:2399-2517."""
    exit_code = 0
    rel_tol = np.finfo(float).eps
    alfnoi = rel_tol / (float(np.linalg.norm(it.p)) + rel_tol)
    preliminary_cond = not (it.restart
                            or (it.code == -1 and alfnoi <= 0.25))
    if preliminary_cond:
        necessary_crit = ((not it.delete)
                          and float(np.linalg.norm(active_C.cx)) < eps_c
                          and it.grad_res < math.sqrt(eps_rel)
                          * (1 + float(np.linalg.norm(gfx))))
        if W.l - W.t > 0:
            inact = W.inactive[: W.l - W.t]
            necessary_crit = necessary_crit and bool(np.all(cx[inact] > 0))
        if W.t > W.q:
            factor = (1 + rx_sum) if W.t == 1 else lam_abs_max
            necessary_crit = necessary_crit and (sigma_min
                                                 >= eps_rel * factor)
        if necessary_crit:
            d1 = it.d_gn[: max(it.dimJ2, 0)]
            x_diff = float(np.linalg.norm(prev.x - x))
            if float(np.dot(d1, d1)) <= rx_sum * eps_rel ** 2:
                exit_code += 10000
            if rx_sum <= eps_abs ** 2:
                exit_code += 2000
            if x_diff < eps_x * float(np.linalg.norm(x)):
                exit_code += 300
            if alfnoi > 0.25:
                exit_code += 40
            if exit_code > 0 and W.l - W.t > 0:
                feas = 1
                for ii in range(W.l - W.t):
                    jj = W.inactive[ii]
                    if cx[jj] <= 0.0:
                        feas = -1
                        break
                exit_code *= feas
    if exit_code == 0:
        x_diff = float(np.linalg.norm(prev.x - x))
        Atcx_nrm = float(np.linalg.norm(active_C.A.T @ active_C.cx))
        act = W.active[: W.t]
        pen_sum = 0.0 if W.t == 0 else float(np.dot(it.w[act], it.w[act]))
        if nb_iter >= max_iter:
            exit_code = -2
        elif -5 <= error_code <= -3:
            exit_code = error_code
        elif it.nb_newton_steps > 5:
            exit_code = -9
        elif psi_error == -1:
            exit_code = -6
        elif (x_diff <= 10.0 * eps_x and Atcx_nrm <= 10.0 * eps_c
              and pen_sum >= 1.0):
            exit_code = -10
        elif delta_time > 0:
            exit_code = -11
    return exit_code


# ------------------------------------------------------------- driver

@dataclasses.dataclass
class TraceRow:
    nb_iter: int
    t: int
    rankA: int
    rankJ2: int
    dimA: int
    dimJ2: int
    code: int
    alpha: float
    add: bool
    delete: bool
    exit_code: int


@dataclasses.dataclass
class OracleResult:
    exit_code: int
    x: np.ndarray
    f: float
    trace: List[TraceRow]
    nb_reseval: int
    nb_conseval: int
    nb_jacres: int
    nb_jaccons: int


def enlsip(x0, fns: Fns, n, m, q, l, scaling=False,
           second_derivatives=True, weight_code=2, max_iter=100,
           eps_abs=1e-10, eps_rel=1e-5, eps_x=1e-3, eps_c=1e-4,
           eps_rank=1e-10) -> OracleResult:
    """Main driver, enlsip_functions.jl:2638-2880 (time limit omitted:
    delta_time is kept permanently negative)."""
    second_derivatives = second_derivatives and (n + m < 1000)
    x0 = np.asarray(x0, float).copy()
    K = [np.zeros(l) for _ in range(4)]
    rx = fns.res(x0)
    J = fns.jac_res(x0)
    cx = fns.cons(x0)
    A = fns.jac_cons(x0)
    x_opt = x0
    f_opt = float(np.dot(rx, rx))
    first_iter = Iteration(
        x=x0.copy(), p=np.zeros(n), rx=rx.copy(), cx=cx.copy(), t=l,
        alpha=1.0, index_alpha_upp=-1, lam=np.zeros(l), w=np.zeros(l),
        rankA=0, rankJ2=0, dimA=0, dimJ2=0, b_gn=np.zeros(n),
        d_gn=np.zeros(n), predicted_reduction=0.0, progress=0.0,
        grad_res=0.0, speed=0.0, beta=0.0, restart=False, first=True,
        add=False, delete=False, index_del=-1, code=1,
        nb_newton_steps=0)
    W = init_working_set(cx, K, first_iter, q, l)
    first_iter.t = W.t
    active_C = Constraint(cx[W.active[: W.t]].copy(),
                          A[W.active[: W.t], :].copy(), scaling,
                          np.zeros(W.t))
    gfx = J.T @ rx
    evaluate_scaling(active_C)
    F_A, F_L11, F_J2, p_gn = update_working_set(W, rx, A, active_C, gfx,
                                                J, first_iter, eps_rank)
    rx_sum = float(np.dot(rx, rx))
    act = W.active[: W.t]
    active_cx_sum = float(np.dot(cx[act], cx[act]))
    first_iter.t = W.t
    previous_iter = first_iter.copy()
    nb_iteration = 0
    error_code = search_direction_analys(
        previous_iter, first_iter, nb_iteration, x0, fns, rx, cx,
        active_C, active_cx_sum, p_gn, J, W, F_A, F_L11, F_J2,
        second_derivatives)
    alpha, w, psi_error = compute_steplength(
        first_iter, previous_iter, x0, fns, rx, J, cx, A, active_C, W,
        K, weight_code)
    first_iter.alpha = alpha
    first_iter.w = w
    x = x0 + alpha * first_iter.p
    rx = fns.res(x)
    J = fns.jac_res(x)
    cx = fns.cons(x)
    A = fns.jac_cons(x)
    gfx = J.T @ rx
    rx_sum = float(np.dot(rx, rx))
    first_iter.restart = error_code < 0
    sigma_min, lam_abs_max = minmax_lagrangian_mult(first_iter.lam, W,
                                                    active_C)
    exit_code = check_termination_criteria(
        first_iter, previous_iter, W, active_C, x, cx, rx_sum, gfx,
        max_iter, nb_iteration, eps_abs, eps_rel, eps_x, eps_c,
        error_code, -1.0, sigma_min, lam_abs_max, psi_error)
    trace = [TraceRow(0, first_iter.t, first_iter.rankA,
                      first_iter.rankJ2, first_iter.dimA,
                      first_iter.dimJ2, first_iter.code,
                      first_iter.alpha, first_iter.add,
                      first_iter.delete, exit_code)]
    first_iter.add = evaluate_violated_constraints(
        cx, W, first_iter.index_alpha_upp, n)
    active_C.cx = cx[W.active[: W.t]].copy()
    active_C.A = A[W.active[: W.t], :].copy()
    previous_iter = first_iter.copy()
    first_iter.x = x.copy()
    first_iter.rx = rx.copy()
    first_iter.cx = cx.copy()
    f_opt = float(np.dot(rx, rx))
    nb_iteration += 1
    it = first_iter.copy()
    it.first = False
    it.add = False
    it.delete = False
    while exit_code == 0:
        evaluate_scaling(active_C)
        F_A, F_L11, F_J2, p_gn = update_working_set(
            W, rx, A, active_C, gfx, J, it, eps_rank)
        act = W.active[: W.t]
        active_cx_sum = float(np.dot(cx[act], cx[act]))
        it.t = W.t
        error_code = search_direction_analys(
            previous_iter, it, nb_iteration, x, fns, rx, cx, active_C,
            active_cx_sum, p_gn, J, W, F_A, F_L11, F_J2,
            second_derivatives)
        alpha, w, psi_error = compute_steplength(
            it, previous_iter, x, fns, rx, J, cx, A, active_C, W, K,
            weight_code)
        it.alpha = alpha
        it.w = w
        x = x + alpha * it.p
        rx = fns.res(x)
        J = fns.jac_res(x)
        cx = fns.cons(x)
        A = fns.jac_cons(x)
        rx_sum = float(np.dot(rx, rx))
        gfx = J.T @ rx
        it.restart = error_code < 0
        sigma_min, lam_abs_max = minmax_lagrangian_mult(it.lam, W,
                                                        active_C)
        exit_code = check_termination_criteria(
            it, previous_iter, W, active_C, x, cx, rx_sum, gfx, max_iter,
            nb_iteration, eps_abs, eps_rel, eps_x, eps_c, error_code,
            -1.0, sigma_min, lam_abs_max, psi_error)
        trace.append(TraceRow(nb_iteration, it.t, it.rankA, it.rankJ2,
                              it.dimA, it.dimJ2, it.code, it.alpha,
                              it.add, it.delete, exit_code))
        if exit_code == 0:
            f_opt = float(np.dot(rx, rx))
            it.add = evaluate_violated_constraints(
                cx, W, it.index_alpha_upp, n)
            active_C.cx = cx[W.active[: W.t]].copy()
            active_C.A = A[W.active[: W.t], :].copy()
            nb_iteration += 1
            previous_iter = it.copy()
            it.x = x.copy()
            it.rx = rx.copy()
            it.cx = cx.copy()
            it.delete = False
            it.add = False
        else:
            x_opt = x
            f_opt = float(np.dot(rx, rx))
    return OracleResult(exit_code=exit_code, x=x_opt, f=f_opt,
                        trace=trace, nb_reseval=fns.nb_reseval,
                        nb_conseval=fns.nb_conseval,
                        nb_jacres=fns.nb_jacres,
                        nb_jaccons=fns.nb_jaccons)
