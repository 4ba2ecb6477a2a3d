"""Fused KKT factorization kernel (csrc/fused_factor.cu).

The counterpart of the JAX package's ``ops/pallas_fused.py``. From the
linearized H-row data of ``ipm._fused_factor_inputs``

    H_k = sum_r wrow_r g_r g_r' + sum_s ucoef_s u_s u_s' + diag(hdiag),
    u_s = sum_{r in soc_ranges[s]} uv_r g_r,

it returns chol(H_k) for every node and the block-tridiagonal Cholesky
factors (L, C) of the Schur system D_k = E_k H_k^-1 E_k' + F_k H_{k+1}^-1 F_k'
+ diag(dpq_k), O_k = F_k H_{k+1}^-1 E_{k+1}'.

``soc_ranges`` is an explicit (S, 2) int32 tensor of [start, end) cone-row
ranges — the JAX package kept it in a module-global side channel.

The wrapper launches the kernel on CUDA tensors (or raises) and uses the
plain PyTorch version on CPU tensors. The kernel takes nw, nrx <= 32 (one
warp lane a row); wider blocks raise on the card. ``fused_factor.launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from successiveconvexification_tpu_torch.ops import _build, smallla

def fused_factor_plain(G_cat, wrow, uv, ucoef, hdiag, E, F, dpq, soc_ranges):
    """Unfused composition: the statement of what the kernel computes.

    G_cat (B, K, R, nw); wrow, uv (B, K, R); ucoef (B, K, S); hdiag (B, K, nw);
    E, F (B, K-1, nrx, nw); dpq (B, K-1, nrx). Returns chol_Hw (B, K, nw, nw),
    L, C (B, K-1, nrx, nrx).
    """
    H = torch.einsum("bkr,bkra,bkrc->bkac", wrow, G_cat, G_cat)
    for s, (o, e) in enumerate(soc_ranges.tolist()):
        u = torch.einsum("bkr,bkra->bka", uv[..., o:e], G_cat[..., o:e, :])
        H = H + ucoef[..., s, None, None] * u[..., :, None] * u[..., None, :]
    H = H + torch.diag_embed(hdiag)
    chol_Hw = smallla.chol(H)
    XE = smallla.cho_solve(chol_Hw[:, :-1], E.transpose(-1, -2))
    XF = smallla.cho_solve(chol_Hw[:, 1:], F.transpose(-1, -2))
    D = E @ XE + F @ XF + torch.diag_embed(dpq)
    O = F[:, :-1] @ XE[:, 1:]
    L, C = smallla.blocktridiag_factor(D, O)
    return chol_Hw, L, C


def fused_factor(G_cat, wrow, uv, ucoef, hdiag, E, F, dpq, soc_ranges):
    """chol_Hw, tri-L, tri-C (see the module docstring for shapes)."""
    ins = (G_cat, wrow, uv, ucoef, hdiag, E, F, dpq)
    if all(t.device.type == "cpu" for t in ins):
        return fused_factor_plain(*ins, soc_ranges)
    sfx = _build.suffix("fused_factor", *ins)
    dev, dtype = G_cat.device, G_cat.dtype
    B, K, R, nw = G_cat.shape
    nrx = E.shape[2]
    S = ucoef.shape[-1]
    shapes_ok = (
        wrow.shape == (B, K, R) and uv.shape == (B, K, R)
        and ucoef.shape == (B, K, S) and hdiag.shape == (B, K, nw)
        and E.shape == (B, K - 1, nrx, nw) and F.shape == E.shape
        and dpq.shape == (B, K - 1, nrx) and K >= 2
        and soc_ranges.shape == (S, 2) and soc_ranges.dtype == torch.int32
        and soc_ranges.device == dev
    )
    if not shapes_ok:
        raise ValueError("fused_factor: inconsistent shapes "
                         f"{[tuple(t.shape) for t in ins]}, soc_ranges "
                         f"{tuple(soc_ranges.shape)} {soc_ranges.dtype}")
    if nw > 32 or nrx > 32:
        raise ValueError(f"fused_factor: nw={nw}, nrx={nrx}; the kernel "
                         "takes blocks of at most 32 (a warp's lanes)")
    ins = [t.contiguous() for t in ins]
    rng = soc_ranges.contiguous()
    chol_Hw = torch.empty((B, K, nw, nw), dtype=dtype, device=dev)
    L = torch.empty((B, K - 1, nrx, nrx), dtype=dtype, device=dev)
    C = torch.empty_like(L)
    fn = _build.declare(_build.library("fused_factor"),
                        f"scvx_fused_factor_{sfx}", 12, 6)
    err = fn(*(t.data_ptr() for t in ins), rng.data_ptr(), chol_Hw.data_ptr(),
             L.data_ptr(), C.data_ptr(), B, K, R, nw, nrx, S,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_factor")
    fused_factor.launches += 1
    return chol_Hw, L, C


fused_factor.launches = 0
