"""Scaling efficiency across rank counts: the counterpart of
``tpudct/parallel/scaling.py``.

Per rank count ``n``: the image is band-sharded once (``shard_image``, no
per-call upload), and the timed op is the band-local ``p.idct(p.dct(x))``
on every rank, each on its device and stream (``sharding._run``); the
outputs stay band-sharded, so no collective sits in the timed span.  The
time is ``utils.timing.device_time_ms`` of the whole step (CUDA events on
the first rank's device around every rank's work, the L2 flushed before
each call, the median); efficiency(n) = throughput(n) / (n * throughput of
the smallest count per rank).

The ranks are the cards (``band_mesh()``).  A count above the number of
cards, or any count with ``device`` named, puts virtual ranks on the
cards, round robin (``["cuda:0"] * 8`` on one card), or on ``device``.
Virtual ranks on one card share its memory bandwidth and its SMs: their
efficiency says how well the rank streams overlap on that card, not how
the codec scales across cards.  On the CPU (``device="cpu"``) the ranks
run one after another and the times are host times.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models import get_pipeline
from tpudct_torch.parallel.mesh import _devices, band_mesh
from tpudct_torch.parallel.sharding import _collect, _expect, _run, shard_image
from tpudct_torch.utils.timing import device_time_ms


def _sharded_pair(pipeline, cfg: CodecConfig, mesh):
    """Band-sharded image -> band-sharded float reconstruction: the
    band-local dct -> idct on every rank."""

    def fn(xs):
        _expect(xs, mesh, "band")
        out = _run(mesh, lambda x: (pipeline.idct(pipeline.dct(x, cfg), cfg),), xs)
        return _collect(mesh, "band", out, 0)

    return fn


def _rank_devices(n: int, device=None) -> list:
    """``n`` ranks on ``device``, or round robin over the cards."""
    cards = _devices(None if device is None else [device])
    return [cards[r % len(cards)] for r in range(n)]


def scaling_table(
    size: int = 2048,
    pipeline: str = "hp",
    device_counts: Optional[Iterable[int]] = None,
    cfg: Optional[CodecConfig] = None,
    reps: int = 3,
    k_pair: Optional[tuple] = None,
    device=None,
) -> list:
    """Throughput and efficiency per rank count.  The counts default to the
    powers of two up to the devices a mesh spans (the cards; one card
    gives ``[1]``, and so does ``device``).  ``k_pair`` is the reference's
    chain-length pin, inert here (see ``utils.timing``)."""
    from tpudct_torch.benchmark import _backend, synthetic_image

    cfg = cfg or CodecConfig()
    p = get_pipeline(pipeline)
    total = len(band_mesh(devices=None if device is None else [device]).devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= total]
    # ascending: efficiency is relative to the smallest count
    device_counts = sorted({int(n) for n in device_counts})

    img = torch.as_tensor(synthetic_image(size))
    rows = []
    base_per_device = None  # throughput per rank at the smallest count
    for n in device_counts:
        mesh = band_mesh(devices=_rank_devices(n, device))
        xs = shard_image(img, mesh)
        op = _sharded_pair(p, cfg, mesh)
        ms = device_time_ms(lambda _x: op(xs), xs.shards[0], k_pair=k_pair, reps=reps)
        ms = max(ms, 1e-6)  # one timer tick at the least
        mpix = size * size / ms / 1e3
        if base_per_device is None:
            base_per_device = mpix / n
        rows.append({
            "devices": n,
            "pair_ms": ms,
            "mpix_per_s": mpix,
            # relative to the smallest measured count: (mpix/n) / (mpix_0/n_0)
            "efficiency": (mpix / n) / base_per_device,
            "backend": _backend(mesh.devices[0]),
        })
    return rows
