"""Linear-algebra ops.

Counterpart of ``mxnet_tpu/ops/linalg.py`` (reference:
src/operator/tensor/la_op.cc: linalg_gemm, potrf, trsm, syrk, gelqf,
syevd, ...), on ``torch.linalg``.  Every op works on the last two axes
and batches over the rest.
"""

from __future__ import annotations

import torch

from .registry import register


def _t(x):
    return x.transpose(-1, -2)


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(A):
    """inv(L L^T) from the Cholesky factor L."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(A, eye, upper=False, left=True)
    return torch.matmul(_t(Linv), Linv)


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve op(A) X = alpha B (X op(A) with ``rightside``), op(A) = A or
    A^T, reading only the ``lower`` (or upper) triangle of A."""
    tri = torch.tril(A) if lower else torch.triu(A)
    upper = not lower
    if transpose:
        tri, upper = _t(tri), lower
    return torch.linalg.solve_triangular(tri, alpha * B, upper=upper,
                                         left=not rightside)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


@register("linalg_gelqf")
def linalg_gelqf(A):
    """The LQ factorisation A = L Q, returned as (L, Q)."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("linalg_syevd")
def linalg_syevd(A):
    """(U, w): the eigenvectors as U's rows, the eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=offset)


@register("linalg_inverse", aliases=("inverse",))
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_det", aliases=("det",))
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("slogdet",))
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("linalg_svd", aliases=("svd",))
def linalg_svd(A):
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    return u, s, vt


def _trian_indices(n, offset, lower, device):
    fn = torch.tril_indices if lower else torch.triu_indices
    return fn(n, n, int(offset), device=device)


@register("linalg_maketrian")
def linalg_maketrian(A, offset=0, lower=True):
    """The inverse of ``linalg_extracttrian``: the packed vector of the
    last axis laid into an (n, n) triangle of the same (offset, lower)
    convention, n the least size whose triangle holds it."""
    m = A.shape[-1]
    n = 1
    while _trian_indices(n, offset, lower, "cpu").shape[1] < m:
        n += 1
    rows, cols = _trian_indices(n, offset, lower, A.device)
    out = A.new_zeros(A.shape[:-1] + (n, n))
    out[..., rows, cols] = A
    return out


@register("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True):
    rows, cols = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]
