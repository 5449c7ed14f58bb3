"""Linear-algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``): the
products, norms, decompositions, solvers and statistics, each a plain
torch body behind ``dispatch.call``. The JAX package's are XLA ops (and
a host LAPACK callback for ``eig``/``eigvals``); the port's are
``torch.linalg``'s, which run on the card (cuSOLVER/MAGMA).

``matmul_body`` is also the port's torch-level ``F.matmul``: one body
for both entries.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = [
    "matmul", "mm", "bmm", "dot", "inner", "outer", "mv", "addmm", "einsum",
    "t", "norm", "dist", "cross", "histogram", "bincount", "matrix_power",
    "cholesky", "cholesky_solve", "inverse", "det", "slogdet", "svd", "qr",
    "lu", "eig", "eigh", "eigvals", "eigvalsh", "solve", "triangular_solve",
    "lstsq", "pinv", "matrix_rank", "cov", "corrcoef", "multi_dot", "cdist",
    "vander", "householder_product", "matrix_transpose", "trace", "rank",
    "pca_lowrank", "lu_unpack", "inv", "cholesky_inverse", "matrix_exp",
    "vector_norm", "matrix_norm", "cond", "svd_lowrank", "ormqr"]


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def matmul_body(x: torch.Tensor, y: torch.Tensor, transpose_x: bool = False,
                transpose_y: bool = False) -> torch.Tensor:
    """Batched product with broadcasting; ``transpose_x``/``transpose_y``
    swap the last two dims of an operand of two dims or more. Mixed
    dtypes promote, as ``jnp.matmul`` promotes them."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


@register("matmul", category="linalg")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """Batched matrix product (paddle.matmul)."""
    return dispatch.call("matmul", matmul_body, [_t(x), _t(y)],
                         {"transpose_x": transpose_x,
                          "transpose_y": transpose_y})


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return dispatch.call("bmm", torch.bmm, [_t(x), _t(y)])


@register("dot", category="linalg")
def dot(x, y, name=None):
    """Dot product over the last axis (batched for 2-D inputs)."""
    return dispatch.call("dot", lambda a, b: (a * b).sum(-1), [_t(x), _t(y)])


@register("einsum", category="linalg")
def einsum(equation, *operands):
    return dispatch.call("einsum", lambda *xs: torch.einsum(equation, *xs),
                         [_t(o) for o in operands])


def t(x, name=None):
    """Transpose of a tensor of at most 2 dims."""
    xt = _t(x)
    if xt.ndim < 2:
        return xt
    return dispatch.call("t", lambda a: a.t(), [xt])


@register("p_norm", category="linalg")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Frobenius (default), nuclear, inf/-inf or p-norm, over ``axis`` or
    the whole tensor."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def f(a):
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(a * a))
            return torch.linalg.norm(a, dim=ax, keepdim=keepdim)
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", dim=ax or (-2, -1),
                                            keepdim=keepdim)
        v = a.reshape(-1) if ax is None else a
        return torch.linalg.vector_norm(v, float(p), dim=ax,
                                        keepdim=keepdim and ax is not None)
    return dispatch.call("p_norm", f, [_t(x)])


def inverse(x, name=None):
    return dispatch.call("inverse", torch.linalg.inv, [_t(x)])


def cholesky(x, upper=False, name=None):
    return dispatch.call("cholesky", lambda a: torch.linalg.cholesky(
        a, upper=upper), [_t(x)])


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch.call("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), [_t(x)])


def inner(x, y, name=None):
    """Inner product over the last dims."""
    return dispatch.call("inner", torch.inner, [_t(x), _t(y)])


def outer(x, y, name=None):
    """Outer product of the flattened inputs."""
    return dispatch.call("outer", lambda a, b: torch.outer(
        a.reshape(-1), b.reshape(-1)), [_t(x), _t(y)])


def mv(x, vec, name=None):
    """Matrix-vector product."""
    return dispatch.call("mv", torch.matmul, [_t(x), _t(vec)])


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y)."""
    return dispatch.call("addmm", lambda i, a, b: beta * i + alpha
                         * torch.matmul(a, b), [_t(input), _t(x), _t(y)])


def matrix_transpose(x, name=None):
    """Swap the last two dims."""
    return dispatch.call("matrix_transpose", lambda a: a.transpose(-1, -2),
                         [_t(x)])


def dist(x, y, p=2, name=None):
    """The p-norm of x - y."""
    from .math import subtract
    return norm(subtract(x, y), p=p)


def cross(x, y, axis=9, name=None):
    """Cross product of 3-vectors along ``axis`` (the first dim of size 3
    when not given)."""
    xt = _t(x)
    ax = axis if axis != 9 else next(i for i, s in enumerate(xt.shape)
                                     if s == 3)
    return dispatch.call("cross", lambda a, b: torch.linalg.cross(
        a, b, dim=ax), [xt, _t(y)])


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """Counts over ``bins`` equal bins of [min, max] (of the data's range
    when both are 0), int64; with ``density``, a density."""
    from .tail import histogram_counts
    ins = [_t(input)] + ([_t(weight)] if weight is not None else [])

    def f(a, *w):
        a = a.float()
        if min != 0 or max != 0:
            lo = torch.full((), float(min), device=a.device)
            hi = torch.full((), float(max), device=a.device)
        else:
            lo, hi = a.min(), a.max()
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                              hi)
        hist, edges = histogram_counts(a, bins, lo, hi,
                                       w[0].float() if w else None)
        if density:
            return hist / hist.sum() / torch.diff(edges)
        return hist.to(torch.int64)
    return dispatch.call("histogram", f, ins,
                         differentiable_mask=[False] * len(ins))


def bincount(x, weights=None, minlength=0, name=None):
    """Occurrences of each non-negative integer (weight sums with
    ``weights``); as long as the largest value + 1."""
    if weights is not None:
        return dispatch.call("bincount", lambda a, w: torch.bincount(
            a.long(), w, minlength).to(w.dtype), [_t(x), _t(weights)],
            differentiable_mask=[False, True])
    return dispatch.call("bincount", lambda a: torch.bincount(
        a.long(), minlength=minlength), [_t(x)])


def matrix_power(x, n, name=None):
    """x to the integer power n (the inverse's for n < 0)."""
    return dispatch.call("matrix_power", lambda a: torch.linalg.matrix_power(
        a, n), [_t(x)])


def cholesky_solve(x, y, upper=False, name=None):
    """Solve A z = x given A's Cholesky factor y."""
    return dispatch.call("cholesky_solve", lambda b, l: torch.cholesky_solve(
        b, l, upper=upper), [_t(x), _t(y)])


def det(x, name=None):
    return dispatch.call("det", torch.linalg.det, [_t(x)])


def slogdet(x, name=None):
    """(sign, log |det|)."""
    return dispatch.call("slogdet", lambda a: tuple(torch.linalg.slogdet(a)),
                         [_t(x)])


def svd(x, full_matrices=False, name=None):
    """(U, S, Vh)."""
    return dispatch.call("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), [_t(x)])


def qr(x, mode="reduced", name=None):
    """(Q, R), reduced or complete."""
    return dispatch.call("qr", lambda a: tuple(torch.linalg.qr(
        a, mode=mode)), [_t(x)])


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 1-based int32 pivots[, info])."""
    def f(a):
        lu_, piv, info = torch.linalg.lu_factor_ex(a)
        outs = (lu_, piv.to(torch.int32))
        return outs + (info.to(torch.int32),) if get_infos else outs
    return dispatch.call("lu", f, [_t(x)])


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) from ``lu``'s packed factor and pivots, P @ L @ U = A."""
    return dispatch.call("lu_unpack", lambda a, p: tuple(torch.lu_unpack(
        a, p.to(torch.int32))), [_t(x), _t(y)],
        differentiable_mask=[True, False])


def eig(x, name=None):
    """(eigenvalues, eigenvectors) of a general matrix, complex64."""
    return dispatch.call("eig", lambda a: tuple(torch.linalg.eig(a)),
                         [_t(x)], differentiable_mask=[False])


def eigh(x, UPLO="L", name=None):
    """(eigenvalues, eigenvectors) of a hermitian matrix."""
    return dispatch.call("eigh", lambda a: tuple(torch.linalg.eigh(
        a, UPLO=UPLO)), [_t(x)])


def eigvals(x, name=None):
    return dispatch.call("eigvals", torch.linalg.eigvals, [_t(x)],
                         differentiable_mask=[False])


def eigvalsh(x, UPLO="L", name=None):
    return dispatch.call("eigvalsh", lambda a: torch.linalg.eigvalsh(
        a, UPLO=UPLO), [_t(x)])


def solve(x, y, name=None):
    """Solve x z = y."""
    return dispatch.call("solve", torch.linalg.solve, [_t(x), _t(y)])


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve with a triangular matrix (``upper`` names the triangle of x,
    or of its transpose with ``transpose``)."""
    def f(a, b):
        a2 = a.transpose(-1, -2) if transpose else a
        return torch.linalg.solve_triangular(a2, b, upper=upper,
                                             unitriangular=unitriangular)
    return dispatch.call("triangular_solve", f, [_t(x), _t(y)])


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) of the least-squares
    problem x z = y, through the SVD as ``jnp.linalg.lstsq``: residuals
    are the squared column norms of y - x z when x has full column rank
    and more rows than columns, else empty."""
    def f(a, b):
        m, n = a.shape[-2], a.shape[-1]
        vec = b.dim() == 1
        bb = b[:, None] if vec else b
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        rc = torch.finfo(a.dtype).eps * builtins_max(m, n) \
            if rcond is None else rcond
        keep = s > rc * s.max()
        inv_s = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
        sol = vh.transpose(-1, -2) @ (inv_s[:, None] * (u.transpose(-1, -2)
                                                       @ bb))
        rank = keep.sum().to(torch.int32)
        resid = ((bb - a @ sol) ** 2).sum(0)
        full = (rank == n) & (m > n)
        resid = resid if m > n else resid[:0]
        resid = torch.where(full, resid, torch.zeros_like(resid))
        return (sol[:, 0] if vec else sol), resid, rank, s
    return dispatch.call("lstsq", f, [_t(x), _t(y)])


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """Moore-Penrose pseudo-inverse."""
    return dispatch.call("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), [_t(x)])


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The number of singular values above ``tol`` (an absolute bound, as
    in Paddle); with no ``tol``, above the default relative bound."""
    if tol is None:
        return dispatch.call("matrix_rank", lambda a: torch.linalg.matrix_rank(
            a, hermitian=hermitian), [_t(x)])
    return dispatch.call("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, atol=tol, rtol=0.0, hermitian=hermitian), [_t(x)])


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Covariance of the rows (``rowvar``) or the columns."""
    return dispatch.call("cov", lambda a: torch.cov(
        a if rowvar else a.T, correction=1 if ddof else 0), [_t(x)])


def corrcoef(x, rowvar=True, name=None):
    """Pearson correlation of the rows (``rowvar``) or the columns."""
    return dispatch.call("corrcoef", lambda a: torch.corrcoef(
        a if rowvar else a.T), [_t(x)])


def multi_dot(tensors, name=None):
    """A chain of products, in the cheapest association."""
    return dispatch.call("multi_dot", lambda *xs: torch.linalg.multi_dot(
        list(xs)), [_t(v) for v in tensors])


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """p-norm distances between the rows of x and of y."""
    def f(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.sum(diff.abs() ** p, -1) ** (1.0 / p)
    return dispatch.call("cdist", f, [_t(x), _t(y)])


def vander(x, n=None, increasing=False, name=None):
    """The Vandermonde matrix of a vector."""
    def f(a):
        powers = torch.arange(a.shape[-1] if n is None else n,
                              device=a.device)
        if not increasing:
            powers = powers.flip(0)
        return a[..., None] ** powers.to(a.dtype)
    return dispatch.call("vander", f, [_t(x)])


def householder_product(x, tau, name=None):
    """The first n columns of the product of the Householder reflectors
    stored below x's diagonal."""
    return dispatch.call("householder_product",
                         torch.linalg.householder_product, [_t(x), _t(tau)])


def rank(x):
    """The number of dims, as an int32 tensor."""
    xt = _t(x)
    return Tensor(torch.full((), xt.ndim, dtype=torch.int32,
                             device=xt._data.device))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """(U, S, V) of the q leading components (of the centered x), from
    the full SVD."""
    xt = _t(x)
    qq = q or builtins_max(1, builtins_min(6, *xt.shape[-2:]))

    def f(a):
        if center:
            a = a - a.mean(-2, keepdim=True)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return u[..., :qq], s[..., :qq], vh.transpose(-1, -2)[..., :qq]
    return dispatch.call("pca_lowrank", f, [xt])


@register("inv", category="linalg")
def inv(x, name=None):
    """``inverse`` under its linalg name."""
    return inverse(x)


@register("cholesky_inverse", category="linalg")
def cholesky_inverse(x, upper=False, name=None):
    """A's inverse from its Cholesky factor."""
    return dispatch.call("cholesky_inverse", lambda l: torch.cholesky_inverse(
        l, upper=upper), [_t(x)])


@register("matrix_exp", category="linalg")
def matrix_exp(x, name=None):
    return dispatch.call("matrix_exp", torch.linalg.matrix_exp, [_t(x)])


@register("vector_norm", category="linalg")
def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """p-norm over the flattened tensor or ``axis`` (0, inf and -inf
    too)."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def f(a):
        dims = tuple(range(a.dim())) if ax is None else ax
        absa = a.abs()
        if p == float("inf"):
            return torch.amax(absa, dim=dims, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(absa, dim=dims, keepdim=keepdim)
        if p == 0:
            return (a != 0).to(a.dtype).sum(dims, keepdim=keepdim)
        return (absa ** p).sum(dims, keepdim=keepdim) ** (1.0 / p)
    return dispatch.call("vector_norm", f, [_t(x)])


@register("matrix_norm", category="linalg")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """fro, nuc, +-1, +-2 or +-inf norm over the two matrix dims."""
    if p not in ("fro", "nuc", 1, -1, 2, -2, float("inf"), float("-inf")):
        raise ValueError(f"unsupported matrix norm order {p!r}")
    return dispatch.call("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, ord=p, dim=tuple(axis), keepdim=keepdim), [_t(x)])


@register("cond", category="linalg")
def cond(x, p=None, name=None):
    """The condition number (the 2-norm's by default)."""
    def f(a):
        if p in (None, 2, -2):
            s = torch.linalg.svdvals(a)
            return (s.amax(-1) / s.amin(-1) if p in (None, 2)
                    else s.amin(-1) / s.amax(-1))
        if p == "fro":
            def fro(m):
                return torch.sqrt((m * m).sum((-2, -1)))
            return fro(a) * fro(torch.linalg.inv(a))
        if p in (1, -1, float("inf"), float("-inf")):
            def pnorm(m):
                sums = m.abs().sum(-2 if builtins_abs(p) == 1 else -1)
                return sums.amax(-1) if p in (1, float("inf")) \
                    else sums.amin(-1)
            return pnorm(a) * pnorm(torch.linalg.inv(a))
        raise ValueError(f"unsupported cond order {p!r}")
    return dispatch.call("cond", f, [_t(x)])


@register("svd_lowrank", category="linalg", differentiable=False)
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized rank-q SVD (subspace iteration with
    re-orthogonalization), the sketch drawn from the device's
    generator."""
    from ..core.generator import default_generator
    from ..core.tensor import graph_break
    graph_break("paddle.linalg.svd_lowrank")
    xt = _t(x)
    d = xt._data
    k = builtins_min(q, builtins_min(d.shape[-2], d.shape[-1]))
    omega = torch.randn(tuple(d.shape[:-2]) + (d.shape[-1], k),
                        dtype=d.dtype, device=d.device,
                        generator=default_generator(d.device))
    ins = [xt, Tensor(omega)] + ([_t(M)] if M is not None else [])

    def f(a, om, *m):
        if m:
            a = a - m[0]
        q_, _ = torch.linalg.qr(a @ om)
        for _ in range(niter):
            z, _ = torch.linalg.qr(a.transpose(-2, -1) @ q_)
            q_, _ = torch.linalg.qr(a @ z)
        b = q_.transpose(-2, -1) @ a
        u, s, vh = torch.linalg.svd(b, full_matrices=False)
        return q_ @ u, s, vh.transpose(-2, -1)
    return dispatch.call("svd_lowrank", f, ins)


@register("ormqr", category="linalg")
def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """Q y, Q^T y, y Q or y Q^T for the full (m x m) Q of the Householder
    reflectors in x and tau (LAPACK's ormqr). The JAX package multiplies
    by the first n columns of Q only, which fits no y of m rows unless x
    is square (ROADMAP Queue 3)."""
    return dispatch.call("ormqr", lambda a, t_, b: torch.ormqr(
        a, t_, b, left=left, transpose=transpose), [_t(x), _t(tau), _t(y)])


builtins_max, builtins_min, builtins_abs = max, min, abs
