"""The measuring verbs of ``python -m tpudct_torch`` (``bench``, ``sweep``,
``table``, ``curve``, ``scale``, ``profile``, ``selftest``, ``compare``,
``info``), the host benches of ``tpudct_torch.benchmark`` and
``parallel.scaling_table``, against ``tpudct.cli`` on the CPU
(``--device cpu``: the kernels' plain twins).

Both CLIs run in process on seeded 64x128 ``.npy`` images.  What must
agree, and how closely:
- timing records: the reference's keys (the times are host times of
  different code, so only their signs are checked); ``backend`` is
  "cpu" in both;
- ``bench --host-entropy``: the same codec list, ``bytes`` and ``factor``
  (the serializer is a copy of the reference's); ``bench --e2e``: the same
  chosen codec and bytes, and the same histogram of the batch's files;
- ``table``, ``curve`` and ``compare`` metrics: within 1e-5 relative (the
  port sums in float64, the reference in f32), SSIM within 1e-4 absolute;
  the compression factors equal;
- ``curve``: ``jpeg_bytes`` and ``jpeg_psnr_db`` equal (the same libjpeg
  call), ``tdc_bytes`` equal where both packages' coefficients are (the
  count of differing coefficient entries is printed per quality; color
  planes may differ in the split's counted +-1 class of ROADMAP §C), the
  BD summary within 0.01;
- ``info``, ``scale``, ``selftest`` and ``profile`` records: the
  reference's keys.  The port's selftest records add "device" and, for
  color420_u8, the twins' counts ("twin_mse", "plane_diffs",
  "recon_diff_pixels"); its family list is the reference's less
  jpg_import, which waits for ROADMAP A.4a(ii).
"""

import json

import numpy as np
import pytest

import tpudct.cli as RCLI
import tpudct_torch.cli as CLI

H, W = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file: the twins' elementwise chains on these
    small maps take as long on one thread as on all of them, and beside
    other test workers a thread per core makes them many times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _photo(seed, channels=0):
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, H)[:, None]
    x = np.linspace(0.0, 1.0, W)[None, :]
    base = 90 + 80 * x * y + 40 * np.sin(9 * x + 4 * y) * np.cos(7 * y)
    if channels:
        base = np.stack([base, base[::-1], np.roll(base, 17, 1)], -1)
    return np.clip(base + rng.normal(0.0, 5.0, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from tpudct.utils.entropy import native_entropy_available

    assert native_entropy_available()  # the reference's loader, before its threads race to it
    d = tmp_path_factory.mktemp("measure")
    np.save(d / "gray.npy", _photo(1))
    np.save(d / "rgb.npy", _photo(2, channels=3))
    return d


def _records(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def _both(capsys, argv, rc=0, device=True) -> tuple:
    assert RCLI.main(argv) == rc
    want = _records(capsys)
    assert CLI.main(argv + (["--device", "cpu"] if device else [])) == rc
    return _records(capsys), want


def _close(g: dict, w: dict, keys=("mse", "psnr_db", "peen_pct")) -> None:
    """The metrics within their tolerances, then every other value equal."""
    g, w = dict(g), dict(w)
    assert g.keys() == w.keys()
    for k in keys:
        if k in w:
            assert abs(g.pop(k) - w.pop(k)) <= 1e-5 * abs(w[k] if k in w else 1) + 1e-9, k
    if "ssim" in w:
        assert abs(g.pop("ssim") - w.pop("ssim")) <= 1e-4
    assert g == w


def test_bench_runs_small(capsys):
    got, want = _both(capsys, ["bench", "--size", "64", "--pipelines", "batched", "--reps", "1"])
    assert len(got) == len(want) == 1 and got[0].keys() == want[0].keys()
    assert got[0]["size"] == 64 and got[0]["dct_ms"] >= 0 and got[0]["backend"] == "cpu"


def test_bench_serving_fused_and_color_rows(capsys):
    """--fused honours --transform, --batch times the serving tier; the
    rows are the reference's, in its order; then --color and --cpu."""
    argv = ["bench", "--size", "128", "--pipelines", "hp", "--fused", "--batch", "2", "--transform", "rdct",
            "--reps", "1"]
    got, want = _both(capsys, argv)
    assert [r.keys() for r in got] == [r.keys() for r in want]
    assert [r["pipeline"] for r in got] == ["hp", "hp-fused", "hp-serving"]
    fused, srv = got[1], got[2]
    assert fused["transform"] == "rdct" and fused["roundtrip_ms"] >= 0
    assert srv["batch"] == 2 and srv["images_per_s"] > 0 and srv["path"] == want[2]["path"]
    assert CLI.main(["bench", "--size", "256", "--pipelines", "hp", "--batch", "2", "--color", "--cpu",
                     "--reps", "1", "--device", "cpu"]) == 0
    rows = _records(capsys)
    assert [r["pipeline"] for r in rows] == ["hp", "hp-serving", "cpu-numpy", "hp-color", "hp-color-serving"]
    assert rows[3]["path"] == "u8-planar" and all(r.get("backend", "cpu") == "cpu" for r in rows)


def test_bench_serving_f32_fallback_for_float_transform(capsys):
    """The exact DCT has no integer core: the serving tier takes the f32
    path, as in the reference."""
    assert CLI.main(["bench", "--size", "128", "--pipelines", "hp", "--batch", "2", "--transform", "dct",
                     "--reps", "1", "--device", "cpu"]) == 0
    srv = _records(capsys)[-1]
    assert srv["pipeline"] == "hp-serving" and srv["path"] == "f32-fallback" and srv["transform"] == "dct"


@pytest.mark.parametrize("image", ["photo", "circuit", "noise"])
def test_bench_host_entropy_is_the_reference(capsys, image):
    got, want = _both(capsys, ["bench", "--host-entropy", "--size", "64", "--image", image, "--reps", "1"],
                      device=False)
    assert [r["codec"] for r in got] == [r["codec"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert (g["bytes"], g["factor"], g["size"], g["image"]) == (w["bytes"], w["factor"], w["size"], w["image"])


def test_bench_e2e_is_the_reference(capsys):
    """bench --e2e: the phases by name and their sum, the chosen codec and
    bytes; the batch flow's histogram and bytes (the port's own batch)."""
    got, want = _both(capsys, ["bench", "--e2e", "--size", "64", "--batch", "3"])
    enc = next(r for r in got if r.get("bench") == "e2e-encode")
    wenc = next(r for r in want if r.get("bench") == "e2e-encode")
    assert enc.keys() == wenc.keys()
    for k in ("load_s", "device_wall_s", "entropy_s", "write_s", "total_s"):
        assert enc[k] >= 0
    assert abs(enc["total_s"] - (enc["load_s"] + enc["device_wall_s"] + enc["entropy_s"] + enc["write_s"])) < 0.05
    assert (enc["chosen_codec"], enc["bytes"]) == (wenc["chosen_codec"], wenc["bytes"])
    bat = next(r for r in got if r.get("bench") == "e2e-batch")
    wbat = next(r for r in want if r.get("bench") == "e2e-batch")
    assert bat.keys() == wbat.keys() and bat["images"] == 3 and bat["backend"] == "cpu"
    assert (bat["codec_histogram"], bat["bytes_total"]) == (wbat["codec_histogram"], wbat["bytes_total"])


def test_sweep_runs_every_pipeline_at_every_size(capsys):
    assert CLI.main(["sweep", "--sizes", "64,128", "--pipelines", "batched,hp", "--reps", "1",
                     "--device", "cpu"]) == 0
    rows = _records(capsys)
    assert [(r["pipeline"], r["size"]) for r in rows] == [("batched", 64), ("hp", 64), ("batched", 128),
                                                          ("hp", 128)]


@pytest.mark.parametrize("argv", [["table", "--pipeline", "batched", "{d}/gray.npy"],
                                  ["table", "--color", "--chroma", "444", "--pipeline", "hp", "{d}/rgb.npy"]],
                         ids=["gray-batched", "color-444-hp"])
def test_table_is_the_reference(files, capsys, argv):
    got, want = _both(capsys, [a.format(d=files) for a in argv])
    assert [r["k"] for r in got] == [6, 7, 8, 9, 10, "std"]
    for g, w in zip(got, want):
        _close(g, w)
    # truncation does not improve the error energy
    key = "psnr_db" if "--color" in argv else "peen_pct"
    assert (got[0][key] <= got[-1][key]) if key == "psnr_db" else (got[0][key] >= got[-1][key])


def test_table_photo_ballpark_parity(capsys):
    """Photographic statistics at the standard table land in the original
    codec's published MSE range (Circuit image: 17.67 at std, up to 79.99
    at k = 6), monotone in k."""
    assert CLI.main(["table", "--pipeline", "hp", "--image", "photo", "--device", "cpu"]) == 0
    rows = _records(capsys)
    std = next(r for r in rows if r["k"] == "std")
    k6 = next(r for r in rows if r["k"] == 6)
    assert 10.0 <= std["mse"] <= 80.0 and std["mse"] <= k6["mse"] <= 120.0
    mses = [r["mse"] for r in rows]
    assert mses == sorted(mses, reverse=True)
    assert CLI.main(["table", "--color", "--pipeline", "batched", "--device", "cpu"]) == 0
    rows = _records(capsys)
    assert len(rows) == 6 and rows[-1]["k"] == "std"
    psnrs = [r["psnr_db"] for r in rows]
    assert psnrs == sorted(psnrs) and all(r["compression_factor"] > 1 for r in rows)


def _coeff_diffs(color: bool, img: np.ndarray, q: int) -> int:
    """Entries where the two packages' coefficients differ at quality q."""
    import jax.numpy as jnp

    import tpudct
    import tpudct_torch
    from tpudct.ops.quant import q_scale_for_quality

    cfg, rcfg = tpudct_torch.CodecConfig(q_scale=q_scale_for_quality(q)), tpudct.CodecConfig(
        q_scale=q_scale_for_quality(q))
    if color:
        from tpudct.models.color import roundtrip_color_auto as rrt
        from tpudct_torch.models.color import roundtrip_color_auto as rt

        pl = rt(tpudct_torch.get_pipeline("hp"), img, cfg, device="cpu")[0]
        rpl = rrt(tpudct.get_pipeline("hp"), img, rcfg)[0]
        return sum(int((pl[k].numpy().astype(np.int64) != np.asarray(rpl[k]).astype(np.int64)).sum()) for k in pl)
    import torch

    c = tpudct_torch.get_pipeline("batched").roundtrip(torch.as_tensor(img, dtype=torch.float32), cfg)[0]
    rc = tpudct.get_pipeline("batched").roundtrip(jnp.asarray(img, jnp.float32), rcfg)[0]
    return int((c.numpy() != np.asarray(rc)).sum())


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_curve_is_the_reference(files, capsys, color):
    """Four qualities: the rows, then the BD summary; PSNR and bytes rise
    with quality."""
    qs = [20, 50, 80, 95]
    src = files / ("rgb.npy" if color else "gray.npy")
    flags = ["--color"] if color else ["--pipeline", "batched"]
    got, want = _both(capsys, ["curve", *flags, "--qualities", ",".join(map(str, qs)), str(src)])
    assert len(got) == len(want) == 5
    img = np.load(src)
    for q, g, w in zip(qs, got[:4], want[:4]):
        n = _coeff_diffs(color, img, q)
        with capsys.disabled():
            print(f"curve color={color} q={q}: {n} coefficient entries differ; tdc_bytes {g['tdc_bytes']} / "
                  f"{w['tdc_bytes']}")
        assert (g["jpeg_bytes"], g["jpeg_psnr_db"], g["quality"]) == (w["jpeg_bytes"], w["jpeg_psnr_db"], q)
        if n == 0:
            assert g["tdc_bytes"] == w["tdc_bytes"]
        else:
            assert color and n <= 0.005 * 3 * img.size
        # gray: the same reconstruction; color: the split's and the merge's
        # counted +-1 classes move the PSNR by far less than 0.01 dB
        tol = 0.01 if color else 1e-5 * w["tdc_psnr_db"]
        assert abs(g["tdc_psnr_db"] - w["tdc_psnr_db"]) <= tol
    for key in ("tdc_psnr_db", "jpeg_psnr_db", "tdc_bytes"):
        vals = [r[key] for r in got[:4]]
        assert vals == sorted(vals), key
    (gs, ws) = got[4], want[4]
    assert gs.keys() == ws.keys() and gs["points"] == ws["points"] == 4
    assert abs(gs["bd_rate_pct_vs_libjpeg"] - ws["bd_rate_pct_vs_libjpeg"]) <= 0.01 + 1e-9
    assert abs(gs["bd_psnr_db_vs_libjpeg"] - ws["bd_psnr_db_vs_libjpeg"]) <= 0.01 + 1e-9


def test_info_is_the_reference(capsys):
    got, want = _both(capsys, ["info"], device=False)
    (g,), (w,) = got, want
    assert g.keys() == w.keys() and g["backend"] == w["backend"] == "cpu" and g["devices"] == ["cpu"]
    for k in ("version", "native_jpeg", "native_entropy", "native_rans", "pipelines", "transforms",
              "transform_aliases", "q_tables"):
        assert g[k] == w[k], k


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    argv = ["profile", "--pipeline", "batched", "--size", "64", "--reps", "1", "--out"]
    assert RCLI.main(argv + [str(tmp_path / "ref")]) == 0
    want = _records(capsys)
    assert CLI.main(argv + [str(tmp_path / "mine"), "--device", "cpu"]) == 0
    got = _records(capsys)
    assert got[0].keys() == want[0].keys() and got[0]["trace_dir"] == str(tmp_path / "mine")
    trace = json.loads((tmp_path / "mine" / "trace.json").read_text())
    assert any(e.get("name") == "batched-roundtrip-64" for e in trace["traceEvents"])


def test_selftest_is_the_reference(capsys):
    """The gate and the families (batched: the color and streamed families
    skip in both); the port's list is the reference's less jpg_import."""
    got, want = _both(capsys, ["selftest", "--pipeline", "batched", "--size", "128", "--families"])
    assert got[0]["gate"] == want[0]["gate"] == "pass"
    fams = [r.get("family") for r in got[1:]]
    assert fams == [r.get("family") for r in want[1:] if r.get("family") != "jpg_import"]
    assert fams == ["color420_u8", "f32", "scaled", "streamed"]
    for g, w in zip(got, [want[0], *(r for r in want[1:] if r.get("family") != "jpg_import")]):
        assert set(w) <= set(g) and set(g) - set(w) <= {"device"}, (g, w)
        assert g["gate"] == w["gate"]


def test_selftest_families_hp(capsys):
    """hp runs every family the port has, each passing, with the reference's
    keys for that family (the reference's hp records, bench.py)."""
    assert CLI.main(["selftest", "--size", "128", "--families", "--device", "cpu"]) == 0
    rows = _records(capsys)
    ref_keys = {
        None: {"gate", "size", "path", "coeff_ties", "recon_max_diff", "mse", "golden_mse"},
        "color420_u8": {"gate", "family", "mse"},
        "f32": {"gate", "size", "path", "coeff_ties", "recon_max_diff", "mse", "golden_mse", "family"},
        "scaled": {"gate", "family", "max_dev", "fast_path"},
        "streamed_gray": {"gate", "family", "bytes"},
        "streamed_color": {"gate", "family", "bytes"},
    }
    assert [r.get("family") for r in rows] == list(ref_keys)
    for r in rows:
        assert r["gate"] == "pass" and ref_keys[r.get("family")] <= set(r)


def test_selftest_reports_a_failure(capsys, monkeypatch):
    import tpudct_torch.selftest as S

    def fail(*a, **k):
        raise AssertionError("coefficient error 3 exceeds the +-1 tie class")

    monkeypatch.setattr(S, "correctness_gate", fail)
    assert CLI.main(["selftest", "--device", "cpu"]) == 1
    assert _records(capsys) == [{"gate": "FAIL", "reason": "coefficient error 3 exceeds the +-1 tie class"}]


def test_compare_images_is_the_reference(tmp_path, capsys):
    """Exit codes 0 (close), 1 (not close), 2 (shapes differ), the metric
    suite, color differences in their channel, an all-zero image."""
    from tpudct_torch.utils.imageio import save_image

    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    save_image(pa, a)
    save_image(pb, a)
    got, want = _both(capsys, ["compare", pa, pb])
    _close(got[0], want[0])
    assert got[0]["close"] and got[0]["max_abs_diff"] == 0.0 and got[0]["mse"] == 0.0
    b = a.copy()
    b[0, 0] ^= 4
    save_image(pb, b)
    got, want = _both(capsys, ["compare", pa, pb], rc=1)
    _close(got[0], want[0])
    got, want = _both(capsys, ["compare", pa, pb, "--tol", "4"])
    _close(got[0], want[0])
    c = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    d = c.copy()
    d[..., 2] ^= 8
    pc, pd = str(tmp_path / "c.npy"), str(tmp_path / "d.npy")
    np.save(pc, c)
    np.save(pd, d)
    got, want = _both(capsys, ["compare", pc, pd], rc=1)
    _close(got[0], want[0])
    assert got[0]["max_abs_diff"] == 8.0
    np.save(pd, c[:16])
    got, want = _both(capsys, ["compare", pc, pd], rc=2)
    assert got == want and got[0]["error"] == "shape_mismatch"
    z = str(tmp_path / "z.png")
    save_image(z, np.zeros((16, 16), np.uint8))
    got, want = _both(capsys, ["compare", z, z])
    _close(got[0], want[0])
    assert got[0]["peen_pct"] == 0.0 and np.isfinite(got[0]["psnr_db"])


def test_compare_streams_is_the_reference(files, tmp_path, capsys):
    """Two .tdc/.tdcc files compare at the coefficient level: equal maps,
    maps of another q_scale (exit 1), gray against color (exit 2)."""
    t = {k: str(tmp_path / k) for k in ("a.tdc", "b.tdc", "q.tdc", "c.tdcc")}
    assert RCLI.main(["encode", str(files / "gray.npy"), t["a.tdc"]]) == 0
    for argv in (["encode", str(files / "gray.npy"), t["b.tdc"]],
                 ["encode", "--q-scale", "1.1", str(files / "gray.npy"), t["q.tdc"]],
                 ["encode", "--color", str(files / "rgb.npy"), t["c.tdcc"]]):
        assert CLI.main(argv + ["--device", "cpu"]) == 0
    capsys.readouterr()
    got, want = _both(capsys, ["compare", t["a.tdc"], t["b.tdc"]])
    assert got == want and got[0]["differing"] == 0 and got[0]["within_tie_class"]
    got, want = _both(capsys, ["compare", t["a.tdc"], t["q.tdc"]], rc=1)
    assert got == want and got[0]["differing"] > 0
    got, want = _both(capsys, ["compare", t["a.tdc"], t["c.tdcc"]], rc=2)
    assert got == want and got[0]["error"] == "shape_mismatch"


def test_scale_is_the_reference(capsys):
    """The rows' keys and rank counts; the port's ranks are CPU devices
    here (virtual ranks: the count says nothing about scaling)."""
    argv = ["scale", "--size", "64", "--devices", "1,2,4", "--k-pair", "1,2", "--reps", "1"]
    got, want = _both(capsys, argv)
    assert [r.keys() for r in got] == [r.keys() for r in want]
    assert [r["devices"] for r in got] == [r["devices"] for r in want] == [1, 2, 4]
    assert got[0]["efficiency"] == 1.0 and all(r["backend"] == "cpu" and r["pair_ms"] > 0 for r in got)
    with pytest.raises(ValueError, match="--k-pair expects A,B"):
        CLI.cmd_scale(CLI.build_parser().parse_args(["scale", "--k-pair", "1,2,3", "--device", "cpu"]))


def test_scaling_table_counts_and_ranks(monkeypatch):
    """Default counts: powers of two up to the devices a mesh spans (one
    for a named device); counts above the cards put virtual ranks on them,
    round robin."""
    import torch

    from tpudct_torch.parallel import scaling

    rows = scaling.scaling_table(64, "batched", reps=1, device="cpu")
    assert [r["devices"] for r in rows] == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert scaling._rank_devices(5) == [torch.device("cuda", i % 2) for i in range(5)]
    assert scaling._rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.scaling_table(64, reps=1)


def test_measuring_verbs_follow_the_device_rule(files, monkeypatch):
    """Nothing falls back to the CPU unasked; the host-only bench and info
    need no card."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["bench", "--size", "64"], ["table", str(files / "gray.npy")], ["selftest"],
                 ["profile", "--size", "64"], ["compare", str(files / "gray.npy"), str(files / "gray.npy")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CLI.main(argv)
    assert CLI.main(["bench", "--host-entropy", "--size", "64", "--reps", "1"]) == 0
    assert CLI.main(["info"]) == 0
