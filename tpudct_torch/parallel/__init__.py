"""Multi-device parallelism: the counterpart of ``tpudct/parallel``.

One process drives every rank of a mesh (a tuple of devices; a device may
repeat, giving virtual ranks on one card).  Images shard as row bands of
8-row multiples (or tiles of a (band, col) grid, or slabs of a batch), each
rank runs the single-device pipeline on its own device and stream with zero
halo, metrics add per-rank partial sums on the first rank's device, and
reassembly is a host gather or a ring all-gather whose hops are CUDA
kernels (B14-B16), decoding each band as it forwards it.  A band-sharded
coefficient map saves to a .tdc or .tdcc without a gather
(``save_sharded``/``save_color_sharded``: one banded segment per rank).
``scaling_table`` times the band-local codec pair per rank count.

After ``distributed_init`` (multi-process bring-up over a gloo process
group) a mesh spans the ranks of every process: each process places its own
slab and drives its own ranks, metrics and ``gather`` all-gather host data,
and the sharded saves exchange compressed segments (process 0 writes).  The
rings stay within one process.

Left out, as the module docstrings say: ``band_spec``/``grid_spec`` (JAX
partition specs).
"""

from tpudct_torch.parallel.mesh import (
    BAND_AXIS,
    COL_AXIS,
    Mesh,
    band_mesh,
    distributed_init,
    grid_mesh,
    process_count,
    process_index,
)
from tpudct_torch.parallel.ring import (
    chroma_band_pack,
    ring_all_gather,
    ring_decode_color_gather,
    ring_decode_gather,
)
from tpudct_torch.parallel.scaling import scaling_table
from tpudct_torch.parallel.sharding import (
    Sharded,
    gather,
    gather_recon,
    save_color_sharded,
    save_sharded,
    shard_batch,
    shard_image,
    shard_image_grid,
    shard_rgb,
    shard_rgb_grid,
    sharded_codec_step,
    sharded_codec_step_grid,
    sharded_color_encode,
    sharded_color_step,
    sharded_color_step_grid,
    sharded_idct,
    sharded_roundtrip,
    sharded_scaled_decode,
    sharded_serving_step,
)

__all__ = [
    "BAND_AXIS",
    "COL_AXIS",
    "Mesh",
    "Sharded",
    "band_mesh",
    "chroma_band_pack",
    "distributed_init",
    "gather",
    "gather_recon",
    "grid_mesh",
    "process_count",
    "process_index",
    "ring_all_gather",
    "ring_decode_color_gather",
    "ring_decode_gather",
    "save_color_sharded",
    "save_sharded",
    "scaling_table",
    "shard_batch",
    "shard_image",
    "shard_image_grid",
    "shard_rgb",
    "shard_rgb_grid",
    "sharded_codec_step",
    "sharded_codec_step_grid",
    "sharded_color_encode",
    "sharded_color_step",
    "sharded_color_step_grid",
    "sharded_idct",
    "sharded_roundtrip",
    "sharded_scaled_decode",
    "sharded_serving_step",
]
