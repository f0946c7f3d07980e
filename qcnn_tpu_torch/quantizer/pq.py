"""Product quantization of dense layers: plain and error-corrected.

Port of ``qcnn_tpu/quantizer/pq.py``, the CVPR'16 Quantized-CNN scheme
(the piece the reference performed offline in MATLAB):

- **plain**: per-sub-space k-means over the weight sub-vectors (one sample
  per output unit per kernel position).
- **input-weighted**: k-means in the metric induced by calibration
  activations: minimizes E_x ||(w - c)·x_s||² = (w-c)ᵀ Σ_s (w-c), i.e.
  Lloyd's in the Σ_s^{1/2}-transformed space.
- **error-corrected**: block coordinate descent over sub-spaces; each
  round refits sub-space s's codebook and assignments against the
  *residual* of the layer response left by all other sub-spaces.

Conventions match the reference layouts (SURVEY.md §2a):
  FC weight (Cout, Cin) → codebooks (S, K, D), assignments (Cout, S)
  Conv kernel (Cout, Cg, kh, kw) → assignments (Cout, kh, kw, S)

The functions on tensors run on the device of their inputs; the layer
wrappers take NumPy arrays and run on the device of their generator, and
return NumPy params as the JAX package's do. Float32 products run without
TF32. The error-corrected rounds (S x rounds sequential steps: 6912 at
AlexNet fc6) factor each sub-space's Gram matrix once per layer and hold
no host sync in the loop: the assignment counts are scatter-adds, the
solves ``cholesky_solve`` on that factor.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from qcnn_tpu_torch.ops.fc import _no_tf32
from qcnn_tpu_torch.quantizer.kmeans import chunk_size, subspace_kmeans
from qcnn_tpu_torch.quantizer.opq import variance_permutation


class PQResult(NamedTuple):
    codebooks: torch.Tensor    # (S, K, D)
    assignments: torch.Tensor  # (n_units, S) int32
    output_mse: torch.Tensor   # scalar; weight-space or response-space MSE


def _split_subvectors(w_units_in: torch.Tensor,
                      num_subspaces: int) -> torch.Tensor:
    """(N_units, Cin) -> (S, N_units, D) with zero padding of the tail
    sub-space (the loader's overhang convention, GetInPdMat clamp)."""
    n, cin = w_units_in.shape
    d = -(-cin // num_subspaces)
    pad = num_subspaces * d - cin
    if pad:
        w_units_in = torch.nn.functional.pad(w_units_in, (0, pad))
    return w_units_in.reshape(n, num_subspaces, d).permute(1, 0, 2)


def _decode_sub(codebooks: torch.Tensor, assigns: torch.Tensor
                ) -> torch.Tensor:
    """(S, K, D) codebooks at (S, N) ids -> (S, N, D) codewords."""
    rows = torch.arange(codebooks.shape[0], device=codebooks.device)
    return codebooks[rows[:, None], assigns.long()]


def quantize_plain(
    gen: torch.Generator,
    w_units_in: torch.Tensor,
    *,
    num_subspaces: int,
    num_codewords: int,
    iters: int = 25,
) -> PQResult:
    """Plain sub-space k-means on the weights."""
    x = _split_subvectors(w_units_in, num_subspaces)
    res = subspace_kmeans(gen, x, num_codewords=num_codewords, iters=iters)
    return PQResult(res.centroids, res.assignments.t(), res.mse)


def _chol_transform(xcal_sub: torch.Tensor, ridge: float) -> torch.Tensor:
    """Cholesky factors L_s of Σ_s = X_sᵀX_s/N + ridge·I, shape (S, D, D)."""
    s, n, d = xcal_sub.shape
    with _no_tf32():
        cov = torch.bmm(xcal_sub.transpose(1, 2), xcal_sub) / n
    return torch.linalg.cholesky(_add_ridge(cov, ridge))


def _add_ridge(gram: torch.Tensor, ridge: float) -> torch.Tensor:
    """gram + (ridge · trace/D + 1e-8) · I, per sub-space."""
    d = gram.shape[-1]
    tr = torch.diagonal(gram, dim1=1, dim2=2).sum(-1)[:, None, None] / d
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    return gram + (ridge * tr + 1e-8) * eye


def _input_weighted_fit(gen, w_sub, x_sub, *, num_codewords, iters, ridge):
    """k-means of the L_sᵀ·w sub-vectors, centroids mapped back through
    L_s⁻ᵀ: (codebooks (S, K, D), assignments (S, N) int32)."""
    chol = _chol_transform(x_sub, ridge)                      # (S, D, D)
    with _no_tf32():
        w_t = torch.bmm(w_sub, chol)                          # Lᵀ w rows
    res = subspace_kmeans(gen, w_t, num_codewords=num_codewords, iters=iters)
    # back-transform: c = L⁻ᵀ c̃  (solve Lᵀ c = c̃)
    c = torch.linalg.solve_triangular(
        chol.transpose(1, 2), res.centroids.transpose(1, 2), upper=True
    ).transpose(1, 2)
    return c, res.assignments


def quantize_input_weighted(
    gen: torch.Generator,
    w_units_in: torch.Tensor,
    xcal: torch.Tensor,
    *,
    num_subspaces: int,
    num_codewords: int,
    iters: int = 25,
    ridge: float = 1e-3,
) -> PQResult:
    """k-means in the activation-covariance metric: cluster L_sᵀ·w
    sub-vectors with Euclidean Lloyd's, map centroids back through L_s⁻ᵀ.
    output_mse is the response error per (sub-space, unit, input)."""
    w_sub = _split_subvectors(w_units_in.float(), num_subspaces)  # (S, N, D)
    x_sub = _split_subvectors(xcal.float(), num_subspaces)        # (S, B, D)
    c, assigns = _input_weighted_fit(gen, w_sub, x_sub,
                                     num_codewords=num_codewords,
                                     iters=iters, ridge=ridge)
    err = w_sub - _decode_sub(c, assigns)
    s, n, _ = err.shape
    b = x_sub.shape[1]
    # the response error a chunk of sub-spaces at a time: the whole
    # (S, B, N) tensor is ~52 GB at VGG-16 fc6's geometry
    total = torch.zeros((), dtype=torch.float32, device=err.device)
    step = chunk_size(b * n, err.device)
    with _no_tf32():
        for i in range(0, s, step):
            e = torch.bmm(x_sub[i:i + step], err[i:i + step].transpose(1, 2))
            total = total + torch.sum(e * e)
    return PQResult(c, assigns.t(), total / (s * n * b))


def quantize_error_corrected(
    gen: torch.Generator,
    w_units_in: torch.Tensor,
    xcal: torch.Tensor,
    *,
    num_subspaces: int,
    num_codewords: int,
    iters: int = 15,
    rounds: int = 3,
    ridge: float = 1e-3,
) -> PQResult:
    """Error-corrected PQ: the input-weighted fit, then ``rounds`` of
    per-sub-space refits against the residual layer response (block
    coordinate descent on ||X·W − X·Ŵ||²). output_mse is the response
    MSE."""
    w_units_in, xcal = w_units_in.float(), xcal.float()
    codebooks, assigns = _input_weighted_fit(
        gen, _split_subvectors(w_units_in, num_subspaces),
        _split_subvectors(xcal, num_subspaces),
        num_codewords=num_codewords, iters=iters, ridge=ridge)
    return _error_corrected_rounds(w_units_in, xcal, codebooks, assigns.t(),
                                   num_subspaces=num_subspaces,
                                   rounds=rounds, ridge=ridge)


def _error_corrected_rounds(w_units_in, xcal, codebooks, assignments, *,
                            num_subspaces, rounds, ridge) -> PQResult:
    """The rounds of :func:`quantize_error_corrected` from codebooks
    (S, K, D) and assignments (N_units, S); deterministic given them.

    Memory shape O(B·N): only the TOTAL approximate response is kept,
    and sub-space si's contribution is recomputed from its codebook when
    its residual is needed; the total is re-summed (one GEMM over the
    decoded weight) at each round start, so incremental update error
    cannot accumulate across rounds."""
    w_sub = _split_subvectors(w_units_in.float(), num_subspaces)  # (S, N, D)
    x_sub = _split_subvectors(xcal.float(), num_subspaces)        # (S, B, D)
    s_cnt, n_units, d = w_sub.shape
    b = x_sub.shape[1]
    k_cnt = codebooks.shape[1]
    dev = w_sub.device
    x_flat = x_sub.permute(1, 0, 2).reshape(b, s_cnt * d)
    w_flat = w_sub.permute(1, 0, 2).reshape(n_units, s_cnt * d)

    def approx_total(codebooks, assigns):
        w_hat = _decode_sub(codebooks, assigns).permute(1, 0, 2)
        return x_flat @ w_hat.reshape(n_units, s_cnt * d).t()

    codebooks = codebooks.float().clone()
    assigns = assignments.t().long().clone()                      # (S, N)
    ones = torch.ones(n_units, dtype=torch.float32, device=dev)
    with _no_tf32():
        y_total = x_flat @ w_flat.t()                             # (B, N)
        # G_s = X_sᵀX_s (+ ridge), the same every round: factored once
        gram = _add_ridge(torch.bmm(x_sub.transpose(1, 2), x_sub), ridge)
        chol, info = torch.linalg.cholesky_ex(gram)
        if bool((info != 0).any()):
            raise ValueError("error-corrected PQ: a sub-space's Gram matrix "
                             "is not positive definite")
        for _ in range(rounds):
            total = approx_total(codebooks, assigns)
            for si in range(s_cnt):
                xs = x_sub[si]                                    # (B, D)
                cb = codebooks[si]                                # (K, D)
                approx_si = xs @ cb[assigns[si]].t()              # (B, N)
                resid = y_total - (total - approx_si)
                # 1) re-assign: codeword responses (B, K) vs residuals;
                # cost[n,k] = ||resid[:,n] - cand[:,k]||² - ||resid[:,n]||²
                cand = xs @ cb.t()
                cost = (torch.sum(cand * cand, dim=0)[None, :]
                        - 2.0 * (resid.t() @ cand))
                a_new = cost.argmin(dim=1)                        # (N,)
                # 2) refit: per codeword k solve
                #    G c_k = X_sᵀ · mean residual of its members
                counts = torch.zeros(k_cnt, dtype=torch.float32, device=dev)
                counts.index_add_(0, a_new, ones)
                member_sums = torch.zeros((b, k_cnt), dtype=torch.float32,
                                          device=dev)
                member_sums.index_add_(1, a_new, resid)           # (B, K)
                rhs = (xs.t() @ member_sums) / counts.clamp_min(1.0)  # (D,K)
                c_new = torch.cholesky_solve(rhs, chol[si]).t()   # (K, D)
                c_new = torch.where(counts[:, None] > 0, c_new, cb)
                codebooks[si] = c_new
                assigns[si] = a_new
                total = total - approx_si + xs @ c_new[a_new].t()
        resp_mse = torch.mean((y_total - approx_total(codebooks, assigns))
                              ** 2)
    return PQResult(codebooks, assigns.t().to(torch.int32), resp_mse)


# ---------------------------------------------------------------------------
# Layer-level wrappers
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def quantize_fc_layer(
    gen: torch.Generator,
    weight_out_in: np.ndarray,
    bias: np.ndarray,
    *,
    num_subspaces: int,
    num_codewords: int,
    xcal: Optional[np.ndarray] = None,
    opq: Optional[str] = None,
    **kwargs,
) -> dict:
    """weight (Cout, Cin) -> PQ fc params dict (NumPy), quantized on the
    device of ``gen``.

    opq="variance" permutes input dims by balanced variance allocation
    before sub-space splitting (quantizer/opq.py); the permutation rides in
    the params dict ("perm") and is applied/folded by ops.fc / prepare.
    """
    _check_uint8_codewords(num_codewords)
    res, perm = _quantize_2d_maybe_opq(
        gen, np.asarray(weight_out_in), xcal,
        num_subspaces=num_subspaces, num_codewords=num_codewords,
        opq=opq, **kwargs,
    )
    out = {
        "codebooks": _np(res.codebooks).astype(np.float32),
        "assignments": _np(res.assignments).astype(np.uint8),
        "bias": np.asarray(bias, np.float32).reshape(-1),
    }
    if perm is not None:
        out["perm"] = perm
    return out


def _check_uint8_codewords(num_codewords: int) -> None:
    """Assignments are stored uint8 end-to-end (the reference's data
    model, SURVEY.md §2a); casting K>256 fits would silently wrap the
    indices mod 256 and decode garbage."""
    if num_codewords > 256:
        raise ValueError(
            f"PQ assignments are uint8: num_codewords must be <= 256, "
            f"got {num_codewords}"
        )


def _opq_perm(w2d, num_subspaces: int, method: str) -> np.ndarray:
    if method != "variance":
        raise ValueError(f"unknown opq method: {method!r}")
    return variance_permutation(np.asarray(w2d), num_subspaces)


def _guard_mse(res: PQResult, w: np.ndarray,
               xcal: Optional[np.ndarray]) -> float:
    """Guard metric for the OPQ keep/drop decision: plain reconstruction
    MSE, or, when calibration inputs are present, the RESPONSE error
    ||X(W - Ŵ)^T||² that the error-corrected fit actually minimizes.
    Decoded in NumPy on the host, as the JAX package does."""
    # imported here: models.prepare imports this package (quantizer.opq)
    from qcnn_tpu_torch.models.prepare import _decode_rows_np

    w_hat = _decode_rows_np(_np(res.codebooks).astype(np.float32),
                            _np(res.assignments), w.shape[1])
    if xcal is None:
        return float(np.mean((w_hat - w) ** 2))
    xc = np.asarray(xcal, np.float32)
    return float(np.mean((xc @ (w_hat - w).T.astype(np.float32)) ** 2))


def _quantize_2d_maybe_opq(gen, w, xcal, *, num_subspaces, num_codewords,
                           opq, **kwargs):
    """Quantize an (N, Cin) matrix; with opq set, fit BOTH the permuted and
    the contiguous split from the same generator state and keep the
    lower-MSE one (the guard makes --opq never worse, with a warning when
    the permutation regressed and was dropped)."""
    state = gen.get_state()

    def fit(wm, xc):
        gen.set_state(state)
        wt = torch.as_tensor(np.asarray(wm, np.float32), device=gen.device)
        if xc is None:
            # EC-only knobs (rounds, ridge) are meaningless without
            # calibration inputs: drop them instead of a TypeError
            plain_kw = {k: v for k, v in kwargs.items() if k in ("iters",)}
            return quantize_plain(
                gen, wt, num_subspaces=num_subspaces,
                num_codewords=num_codewords, **plain_kw,
            )
        return quantize_error_corrected(
            gen, wt,
            torch.as_tensor(np.asarray(xc, np.float32), device=gen.device),
            num_subspaces=num_subspaces, num_codewords=num_codewords,
            **kwargs,
        )

    if opq is None:
        return fit(w, xcal), None
    perm = _opq_perm(w, num_subspaces, opq)
    xcal_p = None if xcal is None else np.asarray(xcal)[:, perm]
    res_perm = fit(w[:, perm], xcal_p)
    res_plain = fit(w, xcal)
    mse_perm = _guard_mse(res_perm, w[:, perm], xcal_p)
    mse_plain = _guard_mse(res_plain, w, xcal)
    if mse_perm <= mse_plain:
        return res_perm, perm
    warnings.warn(
        f"OPQ variance permutation regressed reconstruction MSE "
        f"({mse_perm:.3e} vs {mse_plain:.3e} contiguous) — keeping the "
        f"contiguous split for this layer (KERNEL_STUDIES §14)",
        stacklevel=3,
    )
    return res_plain, None


def quantize_conv_layer(
    gen: torch.Generator,
    kernel_oihw: np.ndarray,
    bias: np.ndarray,
    *,
    num_subspaces: int,
    num_codewords: int,
    xcal: Optional[np.ndarray] = None,
    opq: Optional[str] = None,
    **kwargs,
) -> dict:
    """kernel (Cout, Cg, kh, kw) (reference convKnl layout) -> PQ conv
    params (NumPy), quantized on the device of ``gen``.

    Sub-vectors are the input-channel slices per (output, kernel position)
    — the reference's data model (SURVEY.md §2a). opq="variance" permutes
    the Cg input channels (same permutation for every group — the codebook
    is shared across groups, CaffeEva.cc:534-560).
    """
    _check_uint8_codewords(num_codewords)
    cout, cg, kh, kw = kernel_oihw.shape
    # (Cout, kh, kw, Cg): one Cg-vector per (o, i, j)
    w = np.transpose(kernel_oihw, (0, 2, 3, 1)).reshape(cout * kh * kw, cg)
    res, perm = _quantize_2d_maybe_opq(
        gen, np.asarray(w), xcal,
        num_subspaces=num_subspaces, num_codewords=num_codewords,
        opq=opq, **kwargs,
    )
    assigns = _np(res.assignments).astype(np.uint8).reshape(
        cout, kh, kw, num_subspaces
    )
    out = {
        "codebooks": _np(res.codebooks).astype(np.float32),
        "assignments": assigns,
        "bias": np.asarray(bias, np.float32).reshape(-1),
    }
    if perm is not None:
        out["perm"] = perm
    return out
