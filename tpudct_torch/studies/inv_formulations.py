"""Inverse-transform formulations on the card: the port of
``benchmarks/inv_formulations.py``.

    python -m tpudct_torch.studies.inv_formulations [size]

The TPU study weighed ways to run the exact inverse on a matrix unit with no
f32 path.  Two of them are kernels of their own (``kernels.variants.idct_x``,
haweel, luma table, q_scale 1):

  b  the sublane butterfly and three bf16-digit lane products: hp_idct's
     butterfly tier (B6's kernel)
  c  three bf16-digit products in both directions (B22)

``main`` prints the max error of b and c against the float64 golden model
(``selftest.golden_idct``) on the ``hp_dct`` coefficients of
``synthetic_image(512)``, then times b, c and ``hp_idct`` at "highest",
"high" (which runs the "highest" body in the port) and "butterfly" on the
coefficients of ``synthetic_image(size)`` (default 8192^2) with
``utils.timing.device_time_ms`` (the median of ``REPS`` calls after a
warm-up).  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.kernels import hp
from tpudct_torch.kernels.variants import idct_x
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.selftest import golden_idct
from tpudct_torch.studies import device_label
from tpudct_torch.utils.timing import device_time_ms

__all__ = ["idct_x", "main"]

#: Timed calls per measurement (each after one warm-up call).
REPS = 5


def main(size: int = 8192, device=None) -> dict:
    """Print one line per measurement; return {"size", "card",
    "<variant>_max_err" for b and c against the f64 golden at 512^2,
    "idct_x_<variant>_ms", "hp_idct_<tier>_ms"}."""
    dev = default_device(device)
    label = device_label(dev)
    c = hp.hp_dct(torch.as_tensor(synthetic_image(size), device=dev))
    sc = hp.hp_dct(torch.as_tensor(synthetic_image(512), device=dev))
    g = golden_idct(sc.cpu().numpy())
    out = {"size": size, "card": label}
    for v in ("b", "c"):
        err = float(np.abs(idct_x(sc, v).cpu().numpy().astype(np.float64) - g).max())
        out[f"{v}_max_err"] = err
        print(f"variant {v}: max err vs f64 golden = {err:.2e} (512^2) [{label}]", flush=True)
    for v in ("b", "c"):
        ms = device_time_ms(lambda x, v=v: idct_x(x, v), c, reps=REPS)
        out[f"idct_x_{v}_ms"] = ms
        print(f"{size}^2 idct variant {v}: {ms:.4f} ms [{label}]", flush=True)
    for prec in ("highest", "high", "butterfly"):
        ms = device_time_ms(lambda x, p=prec: hp.hp_idct(x, decode_precision=p), c, reps=REPS)
        out[f"hp_idct_{prec}_ms"] = ms
        print(f"{size}^2 idct {prec}: {ms:.4f} ms [{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
