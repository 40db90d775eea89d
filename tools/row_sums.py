#!/usr/bin/env python3
"""Does a row-wise sum on one CUDA card give bits that depend on the number
of rows?

    python3 tools/row_sums.py

For d = 256, 16 and 128 (the GLMix headline's fixed-effect, per-user and
per-item widths), each row bucket of the serving grid (``bucket_grid(64)``)
at three offsets against the same rows among 32768: ``(x * w).sum(-1)``
(a fixed effect's and a random effect's form) and the port's fixed-order
``models/coefficients.py::row_sum``. Prints, per width and form, the
(bucket, offset) pairs whose bits differ.
"""

import sys

import torch

sys.path.insert(0, ".")


def main() -> int:
    if not torch.cuda.is_available():
        print("tools/row_sums.py: needs a CUDA card", file=sys.stderr)
        return 1
    from photon_tpu_torch.data.padding import bucket_grid
    from photon_tpu_torch.models.coefficients import row_sum

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n = 32768
    for d in (256, 16, 128):
        x = torch.randn(n, d, device=dev, generator=g)
        w = torch.randn(d, device=dev, generator=g)
        W = torch.randn(n, d, device=dev, generator=g)
        forms = {"sum(-1), fixed effect": lambda a, lo, hi: (a * w).sum(-1),
                 "sum(-1), random effect": lambda a, lo, hi: (a * W[lo:hi]).sum(-1),
                 "row_sum, fixed effect": lambda a, lo, hi: row_sum(a * w),
                 "row_sum, random effect": lambda a, lo, hi: row_sum(a * W[lo:hi])}
        for name, f in forms.items():
            full = f(x, 0, n)
            bad = [(b, lo) for b in bucket_grid(64) for lo in (0, 1000, n - b)
                   if not torch.equal(f(x[lo:lo + b], lo, lo + b), full[lo:lo + b])]
            print(f"d = {d}, {name}: {len(bad)} (bucket, offset) pairs differ from 32768 rows {bad}")
    print(f"on {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
