"""A/B of the host rANS stage: the serial stream against the 4-way
interleaved one; the port of ``benchmarks/rans_interleave_ab.py``.

    python -m tpudct_torch.studies.rans_interleave_ab

``utils.entropy.rans_encode(..., interleave=0 | 4)`` over the repo's
``csrc/entropy.c`` (the library both packages build from the same source):
the interleaved construction (symbol i rides state i mod 4, reverse-order
encode into one shared byte stream, forward decode) against the serial one,
on synthetic quantized-coefficient maps with DCT-like positional decay
(2048² and 4096², one band).  Each stream must decode to its map; then the
median of 7 encodes and of 7 decodes each, in MB/s of int16 coefficients,
and the stream sizes.  Host only, timed with the host clock; the streams'
bytes are the reference's for the same maps.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

SIZES = (2048, 4096)
VARIANTS = (("serial", 0), ("interleaved-4", 4))
REPS = 7


def dct_statistics_map(size: int, seed: int = 0) -> np.ndarray:
    """Synthetic quantized-coefficient map with DCT-like positional decay
    (value spread shrinks with the in-block zig-zag distance)."""
    rng = np.random.default_rng(seed)
    c = np.zeros((size, size), np.int16)
    bi = (np.arange(size)[:, None] % 8) + (np.arange(size)[None, :] % 8)
    spread = np.maximum(1, 64 >> np.minimum(bi, 6))
    c[:] = rng.integers(-1, 2, (size, size)) * rng.integers(0, spread + 1)
    c[::8, ::8] = rng.integers(-200, 200, (size // 8, size // 8))
    return c


def _bench(fn, reps: int = REPS) -> float:
    """Median host seconds of fn() over `reps` calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main(sizes=SIZES) -> dict:
    """Print one line per size and variant and one A/B line per size;
    return {size: {variant: {"encode_s", "decode_s", "data"}}}."""
    from tpudct_torch.utils import entropy

    if not entropy.rans_available():
        raise RuntimeError("the host rANS library did not build (utils.native)")
    out = {}
    for size in sizes:
        c = dct_statistics_map(size)
        mb = c.size * 2 / 1e6
        rows = out[size] = {}
        for name, il in VARIANTS:
            data = entropy.rans_encode(c, 1, interleave=il)
            if not np.array_equal(entropy.rans_decode(data, size, size), c):
                raise AssertionError(f"{size}^2 {name}: the stream does not decode to its map")
            te = _bench(lambda il=il: entropy.rans_encode(c, 1, interleave=il))
            td = _bench(lambda d=data: entropy.rans_decode(d, size, size))
            rows[name] = {"encode_s": te, "decode_s": td, "data": data}
            print(f"{size}^2 {name:14s} v{data[0]}: enc {mb / te:6.0f} MB/s  dec {mb / td:6.0f} MB/s  "
                  f"{len(data)} bytes (host clock)", flush=True)
        s, i4 = rows["serial"], rows["interleaved-4"]
        print(f"{size}^2 interleave vs serial: encode {s['encode_s'] / i4['encode_s']:.2f}x, decode "
              f"{s['decode_s'] / i4['decode_s']:.2f}x, size {len(i4['data']) - len(s['data']):+d} B "
              "(host clock)", flush=True)
    return out


if __name__ == "__main__":
    main(tuple(int(a) for a in sys.argv[1:]) or SIZES)
