"""The port's multi-process path (``parallel.mesh.distributed_init`` and the
multi-process branches of ``parallel.sharding``) on the CPU: the
counterpart of tests/test_multihost.py.

Two real processes join a gloo group over a free localhost port, each
driving 2 CPU ranks of a 4-rank mesh and passing only its own slab of each
input.  They run the gray codec step, the color step, the serving step, the
grid codec step on a (2, 2) mesh, ``gather`` of every output, and the
gather-free ``save_sharded``/``save_color_sharded``.  What must hold:

- against the port's single-process run on 4 CPU ranks of the same inputs:
  every gathered array and every file byte-identical, the metrics equal
  (each process adds the all-gathered per-rank partials in rank order, as
  one process does; the reference's own test allows rtol 1e-6, this one
  asks for equality), only process 0 writes, every process returns the
  byte count;
- against the reference's single-process run (its 4-device CPU mesh, hp in
  interpret mode) on the same inputs: gray, grid and serving coefficients
  and reconstructions bit-identical (the hp integer core's class), the
  color reconstruction in the u8 color class of test_torch_parallel.py
  (MSE within 2%, mean absolute difference <= 0.5; the differing count
  printed), metrics within 1e-4 relative (gray) and 2e-2 (color), and the
  sharded files byte-identical to the reference's ``save_sharded`` /
  ``save_color_sharded`` of the same planes.  The reference's own
  two-process save is known to differ from its one-process save (ROADMAP
  section C), so it is not the yardstick.

Each worker has a 120 s limit; the file takes about 15 s.
"""

import hashlib
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpudct_torch
import tpudct_torch.parallel as PP
from tpudct_torch.parallel import mesh as pmesh

_REPO = pathlib.Path(__file__).resolve().parent.parent
# (per-process slabs of) the inputs, made from seeds in every process
GRAY, RGB, BATCH, GRID = (64, 128), (3, 128, 256), (8, 32, 128), (64, 256)


def _inputs() -> dict:
    return {
        "gray": np.random.default_rng(42).integers(0, 256, GRAY).astype(np.float32),
        "rgb": np.random.default_rng(7).integers(0, 256, RGB).astype(np.uint8),
        "batch": np.random.default_rng(9).integers(0, 256, BATCH, dtype=np.uint8),
        "grid": np.random.default_rng(11).integers(0, 256, GRID).astype(np.float32),
    }


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _steps(mesh, gmesh, parts: dict, out_dir: pathlib.Path) -> dict:
    """Every step of the path on `mesh` (and the grid steps on `gmesh`) with
    `parts` as this process's inputs; the gathered results as hashes, the
    metrics as floats, the files' byte counts and hashes."""
    p, cfg = tpudct_torch.get_pipeline("hp"), tpudct_torch.CodecConfig()
    x = PP.shard_image(parts["gray"], mesh)
    (c, r), m = PP.sharded_codec_step(p, cfg, mesh)(x)
    rgb_rec, mc = PP.sharded_color_step(p, cfg, mesh)(PP.shard_rgb(parts["rgb"], mesh))
    (bc, br), bm = PP.sharded_serving_step(p, cfg, mesh)(PP.shard_batch(parts["batch"], mesh))
    (gc, gr), gm = PP.sharded_codec_step_grid(p, cfg, gmesh)(PP.shard_image_grid(parts["grid"], gmesh))
    cstep, meta_fn = PP.sharded_color_encode(p, cfg, mesh)
    cy, ccb, ccr = cstep(PP.shard_rgb(parts["rgb"], mesh))
    out_dir.mkdir(parents=True, exist_ok=True)
    n_tdc = PP.save_sharded(out_dir / "s.tdc", c, cfg.q_scale, cfg.retain_k, orig_shape=GRAY)
    n_tdcc = PP.save_color_sharded(out_dir / "s.tdcc", {"y": cy, "cb": ccb, "cr": ccr}, meta_fn(*RGB[1:]),
                                   cfg.q_scale, cfg.retain_k)
    res = {
        "addressable": [v.is_fully_addressable for v in (x, c, rgb_rec, bc, gc, cy)],
        "shapes": [list(v.shape) for v in (x, c, r, rgb_rec, bc, br, gc, gr, cy, ccb)],
        "tdc_bytes": n_tdc, "tdcc_bytes": n_tdcc,
        "metrics": {k: {n: float(v) for n, v in mm.items()}
                    for k, mm in (("gray", m), ("color", mc), ("serving", bm), ("grid", gm))},
    }
    for k, v in (("coeffs", c), ("recon", r), ("rgb", rgb_rec), ("batch_coeffs", bc), ("batch_recon", br),
                 ("grid_coeffs", gc), ("grid_recon", gr), ("y", cy), ("cb", ccb), ("cr", ccr)):
        res[k] = _sha(PP.gather(v))
    for name in ("s.tdc", "s.tdcc"):
        f = out_dir / name
        res[name] = hashlib.sha256(f.read_bytes()).hexdigest() if f.exists() else None
    return res


_WORKER = r"""
import json, pathlib, sys

pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4])
sys.path.insert(0, sys.argv[5])
sys.path.insert(0, sys.argv[6])
import torch
torch.set_num_threads(1)
from tpudct_torch.parallel import mesh as pmesh
from tpudct_torch.parallel import band_mesh, distributed_init, grid_mesh

distributed_init(f"localhost:{port}", num_processes=nproc, process_id=pid, timeout=90)
distributed_init("localhost:1", num_processes=nproc + 1, process_id=0)  # a second call: a no-op
import test_torch_multiprocess as T

mesh = band_mesh(devices=["cpu"] * 2)
gmesh = grid_mesh((2, 2), devices=["cpu"] * 2)
assert mesh.size == 4 and mesh.processes == (0, 0, 1, 1) and mesh.local_ranks == (2 * pid, 2 * pid + 1)
parts = {}
for k, a in T._inputs().items():
    ax = 1 if k == "rgb" else 0
    n = a.shape[ax] // nproc
    parts[k] = a.take(range(pid * n, (pid + 1) * n), axis=ax)
res = T._steps(mesh, gmesh, parts, out / f"p{pid}")
res["process"] = [pmesh.process_index(), pmesh.process_count()]
(out / f"result{pid}.json").write_text(json.dumps(res))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp")
    script = d / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTEST_CURRENT_TEST", "WORLD_SIZE", "RANK")}
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), "2", str(port), str(d), str(_REPO),
                          str(_REPO / "tests")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for i in range(2)
    ]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=120)[0])
    finally:
        for pr in procs:
            pr.kill()
    assert all(pr.returncode == 0 for pr in procs), "\n".join(logs)
    return d, [json.loads((d / f"result{i}.json").read_text()) for i in range(2)]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    return d, _steps(PP.band_mesh(devices=["cpu"] * 4), PP.grid_mesh((2, 2), devices=["cpu"] * 4), _inputs(), d)


def test_two_processes_match_the_single_process_run(two_processes, single):
    d, (r0, r1) = two_processes
    _sd, one = single
    assert r0["process"] == [0, 2] and r1["process"] == [1, 2]
    assert r0["addressable"] == r1["addressable"] == [False] * 6 and one["addressable"] == [True] * 6
    for k in ("shapes", "tdc_bytes", "tdcc_bytes", "metrics", "coeffs", "recon", "rgb", "batch_coeffs",
              "batch_recon", "grid_coeffs", "grid_recon", "y", "cb", "cr", "s.tdc", "s.tdcc"):
        assert r0[k] == one[k], k
        if k not in ("s.tdc", "s.tdcc"):
            assert r1[k] == one[k], k
    # only process 0 writes; every process returns the byte count
    assert r1["s.tdc"] is None and r1["s.tdcc"] is None
    assert not (d / "p1" / "s.tdc").exists() and (d / "p0" / "s.tdc").stat().st_size == one["tdc_bytes"]


def test_single_process_run_is_the_reference(single):
    """The yardstick of the two-process run against the reference's
    single-process run on the same inputs (4 CPU devices, interpret mode)."""
    import jax.numpy as jnp

    import tpudct
    import tpudct.parallel as RP
    from tpudct.utils.entropy import native_entropy_available

    assert native_entropy_available()  # the reference's loader, before its save threads race to it
    d, one = single
    rp, rcfg = tpudct.get_pipeline("hp"), tpudct.CodecConfig(interpret=True)
    rmesh, rgmesh = RP.band_mesh(4), RP.grid_mesh((2, 2))
    x = _inputs()
    (c, r), m = RP.sharded_codec_step(rp, rcfg, rmesh)(RP.shard_image(jnp.asarray(x["gray"]), rmesh))
    (bc, br), bm = RP.sharded_serving_step(rp, rcfg, rmesh)(RP.shard_batch(jnp.asarray(x["batch"]), rmesh))
    (gc, gr), gm = RP.sharded_codec_step_grid(rp, rcfg, rgmesh)(
        RP.shard_image_grid(jnp.asarray(x["grid"]), rgmesh))
    for k, v in (("coeffs", c), ("recon", r), ("batch_coeffs", bc), ("batch_recon", br),
                 ("grid_coeffs", gc), ("grid_recon", gr)):
        assert one[k] == _sha(np.asarray(RP.gather(v))), k
    for k, mm in (("gray", m), ("serving", bm), ("grid", gm)):
        for name, v in mm.items():
            assert abs(one["metrics"][k][name] - float(v)) <= 1e-4 * abs(float(v)), (k, name)
    assert one["metrics"]["serving"]["images"] == 8.0

    rgb_rec, mc = RP.sharded_color_step(rp, rcfg, rmesh)(RP.shard_rgb(jnp.asarray(x["rgb"]), rmesh))
    p, cfg = tpudct_torch.get_pipeline("hp"), tpudct_torch.CodecConfig()
    mesh = PP.band_mesh(devices=["cpu"] * 4)
    mine, mcm = PP.sharded_color_step(p, cfg, mesh)(PP.shard_rgb(x["rgb"], mesh))
    mine = PP.gather(mine)
    assert _sha(mine) == one["rgb"]
    ref = np.asarray(RP.gather(rgb_rec))
    diff = np.abs(mine.astype(np.float64) - ref)
    mse_m, mse_r = (((a.astype(np.float64) - x["rgb"]) ** 2).mean() for a in (mine, ref))
    print(f"color step vs the reference: {int((diff > 0).sum())} of {diff.size} differ")
    assert abs(mse_m - mse_r) <= 0.02 * mse_r and diff.mean() <= 0.5
    assert abs(one["metrics"]["color"]["mse"] - float(mc["mse"])) <= 2e-2 * float(mc["mse"])

    # the reference's sharded writers on the port's planes: the same bytes
    (mc_, _r), _m = PP.sharded_codec_step(p, cfg, mesh)(PP.shard_image(x["gray"], mesh))
    rc = RP.shard_image(jnp.asarray(PP.gather(mc_)), rmesh)
    n = RP.save_sharded(str(d / "r.tdc"), rc, 1.0, None, orig_shape=GRAY)
    assert n == one["tdc_bytes"] and (d / "r.tdc").read_bytes() == (d / "s.tdc").read_bytes()
    step, meta_fn = PP.sharded_color_encode(p, cfg, mesh)
    planes = {k: RP.shard_image(jnp.asarray(PP.gather(v)), rmesh)
              for k, v in zip(("y", "cb", "cr"), step(PP.shard_rgb(x["rgb"], mesh)))}
    n = RP.save_color_sharded(str(d / "r.tdcc"), planes, meta_fn(*RGB[1:]), 1.0, None)
    assert n == one["tdcc_bytes"] and (d / "r.tdcc").read_bytes() == (d / "s.tdcc").read_bytes()


def test_a_bare_call_on_one_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.distributed_init() is None
    assert not torch.distributed.is_initialized() and pmesh.process_count() == 1
    assert PP.band_mesh(devices=["cpu"] * 2).processes == ()


@pytest.mark.parametrize("kw,exc", [
    ({"num_processes": 2, "process_id": 2}, ValueError),  # no such process
    ({"num_processes": 2}, ValueError),  # an incomplete request
    ({"num_processes": 2, "process_id": 0, "devices": 2}, TypeError),  # an unknown keyword
    ({"num_processes": 2, "process_id": 1, "timeout": 2}, Exception),  # nobody serves the rendezvous
])
def test_an_explicit_cluster_that_fails_raises(kw, exc):
    """An explicit request never falls back to one process silently."""
    with pytest.raises(exc):
        pmesh.distributed_init(f"localhost:{_free_port()}", **kw)
    assert not torch.distributed.is_initialized() and pmesh.process_count() == 1


def test_rings_stay_within_one_process(monkeypatch):
    """A ring (and the streamed sharded roundtrip) on a mesh across
    processes raises instead of reading another process's shards."""
    monkeypatch.setitem(pmesh._CLUSTER, "process_id", 0)
    mesh = PP.Mesh(tuple(torch.device("cpu") for _ in range(4)), (4,), (0, 0, 1, 1))
    xs = PP.shard_image(np.zeros((32, 128), np.uint8), mesh)
    assert not xs.is_fully_addressable and xs.shape == (64, 128) and len(xs.shards) == 2
    with pytest.raises(ValueError, match="within one process"):
        PP.ring_all_gather(xs, mesh)
    from tpudct_torch.utils.streaming import roundtrip_u8_streamed_sharded

    with pytest.raises(ValueError, match="within one process"):
        roundtrip_u8_streamed_sharded(tpudct_torch.get_pipeline("hp"), np.zeros((128, 128), np.uint8), mesh)
