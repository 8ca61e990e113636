#!/usr/bin/env python3
"""Which products give an element other bits on the card when the shape
around it changes: cuBLAS picks its kernel by the shape, and a
tensor-parallel training step matches the whole step only where its
forward keeps the whole step's bits.

At DeepSeek-R1's widths (bf16, TF32 off) it prints, for each product,
the share of elements that differ between the whole product and: the
same rows of a product over half the rows; a product over a quarter of
the columns; the sum of fp32 partial products over quarters of K (a row
piece's sum over `model`); the fp32 product rounded once; the input's
gradient from fp32 partials over quarters of the columns; the weight's
gradient of a quarter of the columns.  Then the plain causal-attention
backward (``flash_prefill_backward``) of 32 of 128 heads of one row, and
of one of two rows, against the whole.

Usage, on a machine with one NVIDIA GPU: ``python3 chip_bits.py``.
"""
import sys
from pathlib import Path


def frac(a, b) -> str:
    return f"{float((a != b).float().mean()):.3e} of elements differ"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bits: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.flash_prefill.flash_prefill import \
        flash_prefill_backward
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device="cuda")
                * scale).bfloat16()

    D, F = 7168, 18432
    for name, (K, N) in {"w_gate": (D, F), "w_dq": (D, 1536),
                         "w_o": (16384, D), "w_down": (F, D),
                         "w_uq": (1536, 24576)}.items():
        x, w = rnd(4096, K), rnd(K, N, scale=K ** -0.5)
        full, rows = x @ w, x[:2048]
        print(name, "M 2048 vs 4096:", frac(rows @ w, full[:2048]))
        print(name, "N/4 columns vs whole:",
              frac(rows @ w[:, :N // 4], full[:2048, :N // 4]))
        kq = K // 4
        parts = sum(rows[:, i * kq:(i + 1) * kq].float()
                    @ w[i * kq:(i + 1) * kq].float() for i in range(4))
        print(name, "fp32 row partials summed vs whole:",
              frac(parts.bfloat16(), full[:2048]))
        print(name, "fp32 product rounded vs bf16 product:",
              frac((rows.float() @ w.float()).bfloat16(), full[:2048]))
        dy = rnd(4096, N)
        nq = N // 4
        dx = sum(dy[:2048, i * nq:(i + 1) * nq].float()
                 @ w[:, i * nq:(i + 1) * nq].float().T for i in range(4))
        print(name, "dx from fp32 column partials vs whole:",
              frac(dx.bfloat16(), (dy @ w.T)[:2048]))
        print(name, "dW of N/4 columns vs whole:",
              frac(rows.T @ dy[:2048, :nq], (rows.T @ dy[:2048])[:, :nq]))
        del x, w, full, rows, dy, dx
    q, k = rnd(2, 2048, 128, 192), rnd(2, 2048, 128, 192)
    v, do = rnd(2, 2048, 128, 128), rnd(2, 2048, 128, 128)
    whole = flash_prefill_backward(q, k, v, do, scale=192 ** -0.5)
    heads = flash_prefill_backward(
        *(t[:1, :, :32].contiguous() for t in (q, k, v, do)),
        scale=192 ** -0.5)
    row = flash_prefill_backward(*(t[:1].contiguous() for t in (q, k, v, do)),
                                 scale=192 ** -0.5)
    for n, a, b, c in zip("qkv", heads, row, whole):
        print(f"attention backward d{n}: 32 heads of row 0 vs whole:",
              frac(a, c[:1, :, :32]), "; row 0 alone vs whole:",
              frac(b, c[:1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
