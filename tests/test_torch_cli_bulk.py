"""The bulk verbs of ``python -m tpudct_torch`` (``batch``, ``unbatch``)
against ``tpudct.cli``, on the CPU (``--device cpu``: the kernels' plain
twins).

Both CLIs run in process on the same directory of seeded ``.npy`` images:
64x128 frames (two of one width, stacked into one launch), a ragged
97x128 and 40x44, an RGB frame and a corrupt file.  What must agree, and
how closely:
- the ``.tdc`` files: byte for byte; each also equals the port's
  ``encode`` of that image alone;
- the ``.tdcc`` files: byte for byte, except where the color split's
  chroma planes differ, +-1 on <= 0.5% of entries (a counted class of
  ROADMAP §C: the reference's split contracts into FMAs); the planes are
  then held to that class, the luma exact, and the byte counts drop out
  of the records;
- the manifests: equal as sets of records keyed by ``file`` (both write
  in completion order);
- the summary records: equal apart from ``ms``;
- ``unbatch`` outputs: gray bit for bit, ``--scale`` too (B7's class
  held no differences here); color +-1 on at most 1e-4 of outputs (the
  merge's exact .5 ties, ROADMAP §C); each count is printed;
- the streamed branches (``streaming.STREAM_PIXELS`` patched down in both
  packages): the same bytes and pixels.
And the port's own rules: a RuntimeError from a stacked launch (a kernel
that does not build or launch) ends the run, unretried and unrecorded;
``probe_image_size`` needs no PIL for ``.npy``; ``--transcode`` waits for
ROADMAP A.4a(ii).
"""

import json
import shutil
import sys

import numpy as np
import pytest

import tpudct.cli as RCLI
import tpudct.utils.serialize as RS
import tpudct_torch.cli as CLI

SHAPES = {"a.npy": (64, 128), "b.npy": (64, 128), "c.npy": (97, 128), "d.npy": (40, 44),
          "e.npy": (64, 128, 3)}


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


def _photo(seed, shape):
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    base = 90 + 80 * x * y + 40 * np.sin(9 * x + 4 * y) * np.cos(7 * y)
    if len(shape) == 3:
        base = np.stack([base, base[::-1], np.roll(base, 17, 1)], -1)
    return np.clip(base + rng.normal(0.0, 5.0, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    from tpudct.utils.entropy import native_entropy_available

    # the reference's host library loaded before its entropy threads first
    # reach it (its loader marks itself tried before it builds: a racing
    # thread finds no library, and `auto` then picks another stage)
    assert native_entropy_available()
    d = tmp_path_factory.mktemp("bulk") / "in"
    d.mkdir()
    for i, (name, shape) in enumerate(SHAPES.items()):
        np.save(d / name, _photo(i + 1, shape))
    (d / "bad.npy").write_bytes(b"\x93NUMPY not a raster")
    return d


def _records(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def _manifest(d) -> dict:
    """file -> its records, in an order that does not depend on the order
    they were written in (a rerun appends records for the same file)."""
    by_file: dict = {}
    for line in (d / "manifest.jsonl").read_text().splitlines():
        rec = json.loads(line)
        by_file.setdefault(rec["file"], []).append(rec)
    return {f: sorted(recs, key=lambda r: json.dumps(r, sort_keys=True)) for f, recs in by_file.items()}


def _last(m: dict) -> dict:
    """file -> its one record (a directory written once)."""
    assert all(len(recs) == 1 for recs in m.values())
    return {f: recs[0] for f, recs in m.items()}


def _summary(got: list, want: list) -> None:
    (g,), (w,) = got, want
    g, w = dict(g), dict(w)
    assert g.pop("ms", {}).keys() == w.pop("ms", {}).keys()
    assert g.pop("manifest").endswith("manifest.jsonl") and w.pop("manifest").endswith("manifest.jsonl")
    assert g == w


def _both(capsys, argv, mine, ref, extra=()) -> tuple:
    """The reference's `argv + [src, ref]` and the port's `argv + [src,
    mine] + --device cpu`; both summary records."""
    assert RCLI.main([*argv, *map(str, ref)]) == 0
    want = _records(capsys)
    assert CLI.main([*argv, *map(str, mine), "--device", "cpu", *extra]) == 0
    return _records(capsys), want


def _same_planes(capsys, label: str, mine: bytes, ref: bytes) -> int:
    pl, meta = RS.bytes_to_color(mine)
    rpl, rmeta = RS.bytes_to_color(ref)
    assert meta == rmeta
    n = 0
    for k in ("y", "cb", "cr"):
        d = np.abs(pl[k] - rpl[k])
        n += int((d > 0).sum())
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, (label, k)
        if k == "y":
            assert not d.any(), label
    with capsys.disabled():
        print(f"{label}: {n} coefficient entries differ")
    return n


def _same_pixels(capsys, label: str, a: np.ndarray, b: np.ndarray, share: float = 0.0) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, label
    d = np.abs(a.astype(np.int16) - b)
    n = int((d > 0).sum())
    with capsys.disabled():
        print(f"{label}: {n} of {a.size} outputs differ (max {int(d.max())})")
    assert d.max() <= 1 and n <= share * a.size, label


BATCHES = {
    "gray": [],
    "gray-q75-rans": ["--jpeg-quality", "75", "--entropy", "rans"],
    "color": ["--color"],
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_batch_is_the_reference(src, tmp_path, capsys, name):
    """Files, manifest and summary; then a rerun skips everything; gray: a
    new file alone is encoded, and another configuration encodes again."""
    flags = BATCHES[name]
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    got, want = _both(capsys, ["batch", *flags, str(src)], [mine], [ref])
    _summary(got, want)
    assert got[0]["encoded"] == 5 and got[0]["failed"] == 1
    ext = ".tdcc" if "--color" in flags else ".tdc"
    m_mine, m_ref = _last(_manifest(mine)), _last(_manifest(ref))
    assert m_mine["bad.npy"] == m_ref["bad.npy"] == {"file": "bad.npy", "error": "decode_failed"}
    for f in SHAPES:
        a, b = (mine / (f + ext)).read_bytes(), (ref / (f + ext)).read_bytes()
        if a != b:
            assert ext == ".tdcc" and _same_planes(capsys, f"batch {name} {f}", a, b)
            del m_mine[f]["bytes"], m_ref[f]["bytes"]
    assert m_mine == m_ref
    if ext == ".tdc":  # each file is the single-image encode's
        for f in ("a.npy", "c.npy", "d.npy"):
            assert CLI.main(["encode", *flags, "--device", "cpu", str(src / f), str(tmp_path / "one.tdc")]) == 0
            assert (tmp_path / "one.tdc").read_bytes() == (mine / (f + ext)).read_bytes(), f
        capsys.readouterr()
    got, want = _both(capsys, ["batch", *flags, str(src)], [mine], [ref])
    _summary(got, want)
    assert got[0]["encoded"] == 0 and got[0]["skipped"] == 6
    if ext == ".tdcc":  # the resume below is the same code for color
        return
    more = tmp_path / "more"
    shutil.copytree(src, more)
    np.save(more / "f.npy", _photo(9, (64, 128)))
    got, want = _both(capsys, ["batch", *flags, str(more)], [mine], [ref])
    _summary(got, want)
    assert got[0]["encoded"] == 1 and got[0]["skipped"] == 6
    got, want = _both(capsys, ["batch", *flags, "--entropy", "xz", str(more)], [mine], [ref])
    _summary(got, want)
    assert got[0]["encoded"] == 6 and got[0]["skipped"] == 1  # the corrupt file stays done


@pytest.fixture(scope="module")
def streams(src, tmp_path_factory):
    """The port's gray and color batch outputs in one directory, with a
    stream whose header parses and whose payload does not, and a file that
    is no stream at all."""
    d = tmp_path_factory.mktemp("streams")
    assert CLI.main(["batch", "--device", "cpu", str(src), str(d)]) == 0
    assert CLI.main(["batch", "--color", "--device", "cpu", str(src), str(d)]) == 0
    good = (d / "a.npy.tdc").read_bytes()
    (d / "cut.tdc").write_bytes(good[: len(good) // 2])
    (d / "bad.tdc").write_bytes(b"TDC4 this is not a stream")
    return d


UNBATCHES = {
    "npy": ["--ext", ".npy"],
    "png": ["--ext", "png"],
    "scale-4/8": ["--ext", ".npy", "--scale", "4/8"],
    "scale-3/8": ["--ext", ".npy", "--scale", "3/8"],
    "scale-2/1": ["--ext", ".npy", "--scale", "2/1"],
}


@pytest.mark.parametrize("name", list(UNBATCHES))
def test_unbatch_is_the_reference(streams, tmp_path, capsys, name):
    """Outputs, manifest and summary; then a rerun skips everything."""
    from tpudct_torch.utils import imageio

    flags = UNBATCHES[name]
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    got, want = _both(capsys, ["unbatch", *flags, str(streams)], [mine], [ref])
    _summary(got, want)
    # 5 gray and 5 color streams and 2 bad ones (color at 2/1 is refused:
    # subsampled chroma caps at M <= 8, a "stream" error in both)
    assert got[0]["decoded"] + got[0]["failed"] == 12 and got[0]["failed"] == (7 if name == "scale-2/1" else 2)
    m_mine, m_ref = _last(_manifest(mine)), _last(_manifest(ref))
    assert m_mine == m_ref
    assert {m_mine[f]["error_kind"] for f in ("bad.tdc", "cut.tdc")} == {"stream"}
    ext = ".png" if "png" in flags else ".npy"
    for f, rec in m_mine.items():
        if "error" in rec:
            continue
        a, b = imageio.load_image(str(mine / rec["out"]), False), imageio.load_image(str(ref / rec["out"]), False)
        _same_pixels(capsys, f"unbatch {name} {f}", np.asarray(a), np.asarray(b),
                     1e-4 if f.endswith(".tdcc") else 0.0)
    got, want = _both(capsys, ["unbatch", *flags, str(streams)], [mine], [ref])
    _summary(got, want)
    assert got[0]["decoded"] == 0 and got[0]["skipped"] == 12


def test_unbatch_ext_normalized_and_resume_per_format(streams, tmp_path, capsys):
    """A bad --ext exits like the reference's; another format or scale
    decodes again, the same one resumes."""
    d = tmp_path / "one"
    d.mkdir()
    shutil.copy(streams / "a.npy.tdc", d)
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    with pytest.raises(SystemExit) as want:
        RCLI.main(["unbatch", "--ext", "webp", str(d), str(ref)])
    with pytest.raises(SystemExit) as got:
        CLI.main(["unbatch", "--ext", "webp", "--device", "cpu", str(d), str(mine)])
    assert str(got.value) == str(want.value)
    for flags, decoded in ((["--ext", "png"], 1), (["--ext", ".npy"], 1), (["--ext", ".png"], 0),
                           (["--ext", ".png", "--scale", "1/2"], 1)):
        got, want = _both(capsys, ["unbatch", *flags, str(d)], [mine], [ref])
        _summary(got, want)
        assert got[0]["decoded"] == decoded, flags
    assert _manifest(mine) == _manifest(ref)


def _boom(*args, **kwargs):
    raise RuntimeError("CUDA error: the kernel did not launch")


@pytest.mark.parametrize("verb, module, fn", [
    ("unbatch", "dispatch", "decode_gray_batch_auto"),
    ("unbatch", "color", "decode_color_batch_auto"),
    ("unbatch --scale 4/8", "dispatch", "decode_gray_scaled_batch_auto"),
    ("batch", "dispatch", "encode_gray_batch_auto"),
    ("batch --color", "color", "encode_color_batch_auto"),
])
def test_a_device_failure_ends_the_run(src, streams, tmp_path, monkeypatch, verb, module, fn):
    """No fallback on the bulk path: a RuntimeError from a stacked launch
    propagates out of main(); nothing retries the group item by item and
    no file's error record is written."""
    import importlib

    mod = importlib.import_module(f"tpudct_torch.models.{module}")
    monkeypatch.setattr(mod, fn, _boom)
    singles = []
    for one in ("decode_gray_auto", "decode_gray_scaled_auto", "encode_gray_auto"):
        monkeypatch.setattr(f"tpudct_torch.models.dispatch.{one}", lambda *a, **k: singles.append(a))
    for one in ("decode_color_auto", "encode_color_auto"):
        monkeypatch.setattr(f"tpudct_torch.models.color.{one}", lambda *a, **k: singles.append(a))
    argv = verb.split() + ["--device", "cpu", str(streams if verb.startswith("unbatch") else src),
                           str(tmp_path / "out")]
    if verb.startswith("unbatch"):
        argv[1:1] = ["--ext", ".npy"]
    with pytest.raises(RuntimeError, match="did not launch"):
        CLI.main(argv)
    assert singles == []
    manifest = tmp_path / "out" / "manifest.jsonl"
    recs = [json.loads(line) for line in manifest.read_text().splitlines()] if manifest.exists() else []
    assert not any("launch" in r.get("error", "") for r in recs)


def test_unbatch_stacked_failure_falls_back_per_file(streams, tmp_path, capsys, monkeypatch):
    """A ValueError from the stacked launch (a corrupt but parseable
    stream) redoes the group one stream at a time: the same pixels."""
    import tpudct_torch.models.dispatch as dispatch

    def reject(*args, **kwargs):
        raise ValueError("stacked launch rejected")

    base = tmp_path / "base"
    assert CLI.main(["unbatch", "--ext", ".npy", "--device", "cpu", str(streams), str(base)]) == 0
    monkeypatch.setattr(dispatch, "decode_gray_batch_auto", reject)
    out = tmp_path / "out"
    assert CLI.main(["unbatch", "--ext", ".npy", "--device", "cpu", str(streams), str(out)]) == 0
    rep = _records(capsys)[-1]
    assert rep["decoded"] == 10 and rep["failed"] == 2
    for f in ("a.npy.tdc", "c.npy.tdc", "d.npy.tdc"):
        assert np.array_equal(np.load(out / (f + ".npy")), np.load(base / (f + ".npy"))), f


def test_batch_waves_split_by_probed_pixels(src, tmp_path, capsys, monkeypatch):
    """Forcing one-file waves (every probe huge) changes no output."""
    from tpudct_torch.utils import imageio

    assert CLI.main(["batch", "--device", "cpu", str(src), str(tmp_path / "ref")]) == 0
    monkeypatch.setattr(imageio, "probe_image_size", lambda path: (1 << 62, 1))
    assert CLI.main(["batch", "--device", "cpu", str(src), str(tmp_path / "tdc")]) == 0
    rep = _records(capsys)[-1]
    assert rep["encoded"] == 5 and rep["failed"] == 1
    for f in SHAPES:
        assert (tmp_path / "tdc" / (f + ".tdc")).read_bytes() == (tmp_path / "ref" / (f + ".tdc")).read_bytes()


def test_streamed_branches_are_the_reference(src, tmp_path, capsys, monkeypatch):
    """Above the threshold (patched down to 4000 pixels in both packages:
    the 64x128 and 97x128 frames stream, the 40x44 one does not) batch
    writes banded streams and unbatch decodes them band by band, into
    .npy memmaps; the files, pixels and records are the reference's."""
    import tpudct.utils.streaming as RST
    import tpudct_torch.utils.streaming as ST

    monkeypatch.setattr(RST, "STREAM_PIXELS", 4000)
    monkeypatch.setattr(ST, "STREAM_PIXELS", 4000)
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    got, want = _both(capsys, ["batch", str(src)], [mine], [ref])
    _summary(got, want)
    m = _last(_manifest(mine))
    assert m == _last(_manifest(ref))
    assert sorted(f for f, r in m.items() if r.get("streamed")) == ["a.npy", "b.npy", "c.npy", "e.npy"]
    for f in SHAPES:
        assert (mine / (f + ".tdc")).read_bytes() == (ref / (f + ".tdc")).read_bytes(), f
    assert CLI.main(["batch", "--color", "--device", "cpu", str(src), str(mine)]) == 0
    capsys.readouterr()
    for flags in (["--ext", ".npy"], ["--ext", ".npy", "--scale", "4/8"], ["--ext", ".png"]):
        out_mine, out_ref = tmp_path / f"o{len(flags)}{flags[1]}.mine", tmp_path / f"o{len(flags)}{flags[1]}.ref"
        got, want = _both(capsys, ["unbatch", *flags, str(mine)], [out_mine], [out_ref])
        _summary(got, want)
        mm = _last(_manifest(out_mine))
        assert mm == _last(_manifest(out_ref))
        assert sum(bool(r.get("streamed")) for r in mm.values()) == 8  # 4 gray, 4 color
        for rec in mm.values():
            if flags[1] == ".npy":
                a, b = np.load(out_mine / rec["out"]), np.load(out_ref / rec["out"])
            else:
                from PIL import Image

                a, b = (np.asarray(Image.open(d / rec["out"])) for d in (out_mine, out_ref))
            _same_pixels(capsys, f"streamed unbatch {flags} {rec['file']}", a, b,
                         1e-4 if rec["file"].endswith(".tdcc") else 0.0)


def test_probe_image_size_is_the_reference(tmp_path, monkeypatch):
    """The same answer for .npy, .png, a corrupt file and a missing one;
    .npy without PIL (the card's machine may have none)."""
    import tpudct.utils.imageio as RIO
    from PIL import Image

    from tpudct_torch.utils import imageio

    np.save(tmp_path / "x.npy", np.zeros((24, 40), np.uint8))
    Image.fromarray(np.zeros((24, 40), np.uint8)).save(tmp_path / "x.png")
    (tmp_path / "bad.png").write_bytes(b"not a png")
    for name in ("x.npy", "x.png", "bad.png", "missing.png"):
        assert imageio.probe_image_size(str(tmp_path / name)) == RIO.probe_image_size(str(tmp_path / name))
    assert imageio.probe_image_size(str(tmp_path / "x.png")) == (24, 40)
    monkeypatch.setitem(sys.modules, "PIL", None)  # `import PIL` now raises
    assert imageio.probe_image_size(str(tmp_path / "x.npy")) is None
    with pytest.raises(ImportError):
        imageio.probe_image_size(str(tmp_path / "x.png"))


@pytest.mark.parametrize("argv", [
    ["batch", "--transcode", "{d}", "{d}/out"],
    ["unbatch", "--transcode", "--ext", ".jpg", "{d}", "{d}/out"],
    ["transcode", "{d}/a.jpg", "{d}/a.tdc"],
    ["edit", "--op", "rot90", "{d}/a.tdc", "{d}/b.tdc"],
])
def test_coefficient_io_waits_for_its_slice(tmp_path, capsys, argv):
    dev = ["--device", "cpu"] if argv[0] in ("batch", "unbatch") else []
    assert CLI.main([a.format(d=tmp_path) for a in argv] + dev) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "ROADMAP A.4a(ii)" in err, err


def test_bulk_verbs_follow_the_device_rule(src, streams, tmp_path, monkeypatch):
    """Nothing falls back to the CPU unasked."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["batch", str(src), str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["unbatch", str(streams), str(tmp_path / "b")])
