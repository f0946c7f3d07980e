"""Plain decoding of product-quantized weights (float32, no kernels), and
the operand precisions of the reference's products.

A PQ layer holds codebooks C (S, K, D) and uint8 ids. Its dense weight row
n is the concatenation over sub-spaces s of C[s, ids[n, s]], cut to the
layer's input width (the last sub-space may overhang it)."""

from __future__ import annotations

import torch


def decode_rows(codebooks: torch.Tensor, ids: torch.Tensor,
                width: int) -> torch.Tensor:
    """(N, S) ids -> (N, width) float32 rows."""
    s, _, d = codebooks.shape
    cb = codebooks.float()
    rows = cb[torch.arange(s, device=cb.device)[None, :], ids.long()]
    return rows.reshape(ids.shape[0], s * d)[:, :width]


def decode_conv(codebooks: torch.Tensor, ids: torch.Tensor,
                cin: int) -> torch.Tensor:
    """(Cout, kh, kw, S) ids -> (Cout, cin, kh, kw) float32 kernel."""
    cout, kh, kw, s = ids.shape
    w = decode_rows(codebooks, ids.reshape(-1, s), cin)
    return w.reshape(cout, kh, kw, cin).permute(0, 3, 1, 2).contiguous()


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at one scale for the whole tensor
    (its largest |value| goes to 448, the format's largest), back in
    float32: the operand of an fp8 product. The reference computed so is
    the control of the benchmark's comparison."""
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def same(t: torch.Tensor) -> torch.Tensor:
    return t


class NoTF32:
    """float32 products without TF32 while inside."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
