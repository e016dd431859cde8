"""``python -m tpudct_torch`` (tpudct_torch.cli) against ``tpudct.cli``, on
the CPU (``--device cpu``: the kernels' plain twins).

Same seeded 64x128 images (gray and RGB ``.npy``) through both CLIs, in
process.  What must agree, and how closely:
- the ``.tdc`` files: byte for byte (hp haweel default, ``--jpeg-quality
  75``, ``--q-table-file``, ``--k 6``, ``run --coeffs``); the ``.tdcc``
  files too, except where the color split's chroma planes differ, +-1 on
  <= 0.5% of entries (a counted class of ROADMAP §C: the reference's split
  contracts into FMAs), and then the planes are held to that class;
- each package decodes each file as the other does, in every decode mode;
- the reconstructions: gray bit for bit, color +-1 on <= 1e-4 of outputs
  (the merge's exact .5 ties, ROADMAP §C); each count is printed;
- the JSON records: the same keys, and the same values apart from the
  ``ms`` phase timings, except ``run``'s accuracy metrics, which the port
  sums in float64 and the reference in float32 (MSE/PSNR/PEEN within 1e-5
  relative, SSIM within 1e-4, as in test_torch_benchmark.py).
"""

import json
from pathlib import Path

import numpy as np
import pytest

import tpudct.cli as RCLI
import tpudct.utils.serialize as RS
import tpudct_torch.cli as CLI

H, W = 64, 128


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
    d = tmp_path_factory.mktemp("cli")
    np.save(d / "gray.npy", _photo(1))
    np.save(d / "rgb.npy", _photo(2, channels=3))
    qt = (np.arange(64).reshape(8, 8) % 13 + 3) * 2
    (d / "q.txt").write_text("# a custom table\n" + "\n".join(", ".join(map(str, r)) for r in qt))
    return d


def _records(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def _both(capsys, argv: list, mine: list, ref: list) -> tuple:
    """Run the reference with `argv + ref`, the port with `argv + mine +
    --device cpu` (where the verb takes it); return both JSON records."""
    assert RCLI.main(argv + ref) == 0
    want = _records(capsys)
    dev = [] if argv[0] == "inspect" else ["--device", "cpu"]
    assert CLI.main(argv + mine + dev) == 0
    got = _records(capsys)
    return got, want


def _same_records(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        assert g.pop("ms", {}).keys() == w.pop("ms", {}).keys()
        assert g == w


def _same_pixels(capsys, label: str, a: np.ndarray, b: np.ndarray, share: float = 0.0) -> None:
    """Bit for bit, or +-1 on at most `share` of the outputs (a counted
    class of ROADMAP §C); the count is printed."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, label
    d = np.abs(a.astype(np.int16) - b)
    n = int((d > 0).sum())
    with capsys.disabled():
        print(f"{label}: {n} of {a.size} outputs differ (max {int(d.max())})")
    assert d.max() <= 1 and n <= share * a.size, label


def _same_planes(capsys, label: str, mine: bytes, ref: bytes) -> int:
    """The color split's chroma is +-1 on <= 0.5% of entries (XLA's FMA
    contraction in the reference's split, a counted class of ROADMAP §C),
    so two .tdcc files may hold different planes (test_torch_serialize.py
    holds the bytes for the same planes): the planes within that class, the
    luma exact.  Returns the count of differing entries."""
    pl, meta = RS.bytes_to_color(mine)
    rpl, rmeta = RS.bytes_to_color(ref)
    assert meta == rmeta
    n = 0
    for k in ("y", "cb", "cr"):
        d = np.abs(pl[k] - rpl[k])
        n += int((d > 0).sum())
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, (label, k)
        if k == "y":
            assert not d.any(), label  # the luma is exact integer arithmetic
    with capsys.disabled():
        print(f"{label}: {n} coefficient entries differ")
    return n


ENCODES = {
    "gray": [],
    "jpeg-quality-75": ["--jpeg-quality", "75"],
    "q-table-file": ["--q-table-file", "{d}/q.txt"],
    "k6": ["--k", "6", "--entropy", "rans"],
    "color-420": ["--color"],
    "color-422": ["--color", "--chroma", "422", "--entropy", "xz"],
    "color-444": ["--color", "--no-subsample", "--entropy", "banded:2:spectral"],
}


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_decode_inspect_are_the_reference(files, capsys, name):
    d = files
    flags = [f.format(d=d) for f in ENCODES[name]]
    color = "--color" in flags
    src, ext = (d / "rgb.npy", "tdcc") if color else (d / "gray.npy", "tdc")
    mine, ref = d / f"{name}.mine.{ext}", d / f"{name}.ref.{ext}"
    assert RCLI.main(["encode", *flags, str(src), str(ref)]) == 0
    want = _records(capsys)
    assert CLI.main(["encode", *flags, "--device", "cpu", str(src), str(mine)]) == 0
    got = _records(capsys)
    if color and mine.read_bytes() != ref.read_bytes() and _same_planes(capsys, name, mine.read_bytes(), ref.read_bytes()):
        for r in (*got, *want):  # the byte counts follow the planes
            del r["bytes"], r["factor_vs_raw"]
    else:
        assert mine.read_bytes() == ref.read_bytes()
    _same_records(got, want)
    # each decodes the other's file, as the other decodes it
    share = 1e-4 if color else 0.0
    for f in (ref, mine):
        out = [d / f"{name}.{f.stem}.{who}.npy" for who in ("mine", "ref")]
        got, want = _both(capsys, ["decode", str(f)], [str(out[0])], [str(out[1])])
        _same_records(got, want)
        _same_pixels(capsys, f"decode {name} of {f.name}", np.load(out[0]), np.load(out[1]), share)
    got, want = _both(capsys, ["inspect", str(mine), str(ref)], [], [])
    assert [g.pop("file") for g in got] == [str(mine), str(ref)]
    assert [w.pop("file") for w in want] == [str(mine), str(ref)]
    assert got == want


# decode modes: (stream, flags)
DECODES = {
    "scale-2/8": ("gray", ["--scale", "2/8"]),
    "scale-3/8": ("gray", ["--scale", "3/8"]),
    "scale-1/1": ("gray", ["--scale", "1/1"]),
    "preview": ("gray", ["--preview"]),
    "planes-6": ("gray", ["--planes", "6"]),
    "rows": ("gray", ["--rows", "5:40"]),
    "color-scale-4/8": ("color-420", ["--scale", "4/8"]),
    "color-scale-6/8": ("color-420", ["--scale", "6/8"]),
    "color-grayscale": ("color-420", ["--grayscale"]),
    "color-grayscale-scale": ("color-420", ["--grayscale", "--scale", "2/8"]),
    "color-preview": ("color-420", ["--preview"]),
    "color-grayscale-preview": ("color-420", ["--grayscale", "--preview"]),
    "color-planes-3": ("color-420", ["--planes", "3"]),
    "color-grayscale-planes": ("color-420", ["--grayscale", "--planes", "10"]),
    "color-rows": ("color-420", ["--rows", "9:50"]),
    "color-grayscale-rows": ("color-420", ["--grayscale", "--rows", "3:30"]),
    "color-422-rows": ("color-422", ["--rows", "20:61"]),
}


@pytest.mark.parametrize("name", list(DECODES))
def test_decode_modes_are_the_reference(files, capsys, name):
    d = files
    stream, flags = DECODES[name]
    ext = "tdcc" if stream.startswith("color") else "tdc"
    src = d / f"{stream}.port.{ext}"
    if not src.exists():  # the port's file, for every mode of this stream
        extra = ["--color"] + (["--chroma", "422"] if stream == "color-422" else []) if ext == "tdcc" else []
        npy = d / ("rgb.npy" if ext == "tdcc" else "gray.npy")
        assert CLI.main(["encode", *extra, "--device", "cpu", str(npy), str(src)]) == 0
        capsys.readouterr()
    out = [d / f"{name.replace('/', '_')}.{who}.npy" for who in ("mine", "ref")]
    got, want = _both(capsys, ["decode", *flags, str(src)], [str(out[0])], [str(out[1])])
    _same_records(got, want)
    _same_pixels(capsys, f"decode {name}", np.load(out[0]), np.load(out[1]), 1e-4 if ext == "tdcc" else 0.0)


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_run_is_the_reference(files, capsys, color):
    d = files
    src = d / ("rgb.npy" if color else "gray.npy")
    ext = "tdcc" if color else "tdc"
    flags = ["--color"] if color else []
    assert RCLI.main(["run", *flags, str(src), str(d / "run.ref.png"), "--coeffs", str(d / f"run.ref.{ext}")]) == 0
    want = _records(capsys)
    assert CLI.main(["run", *flags, "--device", "cpu", str(src), str(d / "run.mine.png"),
                     "--coeffs", str(d / f"run.mine.{ext}")]) == 0
    got = _records(capsys)
    assert (d / f"run.mine.{ext}").read_bytes() == (d / f"run.ref.{ext}").read_bytes()
    if not color:  # run --coeffs writes what encode writes
        CLI.main(["encode", "--device", "cpu", str(src), str(d / "run.enc.tdc")])
        capsys.readouterr()
        assert (d / "run.enc.tdc").read_bytes() == (d / "run.mine.tdc").read_bytes()
    from PIL import Image

    _same_pixels(capsys, f"run color={color}", np.asarray(Image.open(d / "run.mine.png")),
                 np.asarray(Image.open(d / "run.ref.png")))
    (g,), (w,) = got, want
    assert g.keys() == w.keys()
    for k, tol in (("mse", 1e-5), ("psnr_db", 1e-5), ("peen_pct", 1e-5)):
        if k in w:
            assert abs(g.pop(k) - w.pop(k)) <= tol * abs(w[k] if k in w else 1) + tol, k
    if "ssim" in w:
        assert abs(g.pop("ssim") - w.pop("ssim")) <= 1e-4
    assert g == w


def test_run_corners_is_the_reference(files, capsys):
    """--corners: the original codec's four stage dumps and phase times."""
    d = files
    assert RCLI.main(["run", "--corners", str(d / "gray.npy"), str(d / "c.ref.png")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert CLI.main(["run", "--corners", "--device", "cpu", str(d / "gray.npy"), str(d / "c.mine.png")]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith(("DCT (", "IDCT (")):
            assert g.split(":")[0] == w.split(":")[0]
        elif not g.startswith("{"):
            assert g == w


@pytest.mark.parametrize("argv", [
    ["encode", "--band-rows", "16", "{d}/gray.npy", "{d}/x.{who}.tdc"],
    ["encode", "--color", "--band-rows", "16", "{d}/rgb.npy", "{d}/x.{who}.tdcc"],
    ["decode", "--band-rows", "16", "{d}/gray.port.tdc", "{d}/x.{who}.npy"],
], ids=["encode", "encode-color", "decode"])
def test_band_rows_streams_like_the_reference(files, capsys, argv):
    """--band-rows streams (tpudct_torch.utils.streaming): the files and the
    records are the reference CLI's (a .tdcc within the color split's
    class, as above)."""
    from tpudct.utils.entropy import native_entropy_available

    # the reference's host library loaded before its two entropy threads
    # first reach it (its loader marks itself tried before it builds, so a
    # racing thread can find no library and `auto` then picks another stage)
    assert native_entropy_available()
    d = files
    if not (d / "gray.port.tdc").exists():
        assert CLI.main(["encode", "--device", "cpu", str(d / "gray.npy"), str(d / "gray.port.tdc")]) == 0
        capsys.readouterr()
    assert RCLI.main([a.format(d=d, who="ref") for a in argv]) == 0
    want = _records(capsys)
    assert CLI.main([a.format(d=d, who="mine") for a in argv] + ["--device", "cpu"]) == 0
    got = _records(capsys)
    mine, ref = (Path(argv[-1].format(d=d, who=who)) for who in ("mine", "ref"))
    if mine.suffix == ".npy":
        _same_pixels(capsys, "decode --band-rows", np.load(mine), np.load(ref))
    elif mine.suffix == ".tdcc" and mine.read_bytes() != ref.read_bytes() and _same_planes(
            capsys, "encode --color --band-rows", mine.read_bytes(), ref.read_bytes()):
        for r in (*got, *want):  # the byte counts follow the planes
            del r["bytes"], r["factor_vs_raw"]
    else:
        assert mine.read_bytes() == ref.read_bytes()
    assert all(r.get("streamed") for r in got) and all(r.get("streamed") for r in want)
    _same_records(got, want)


@pytest.mark.parametrize("argv,what", [
    (["decode", "{d}/x.jpg", "{d}/x.npy"], "coefficient read failed .*: cannot open file"),
    (["decode", "{d}/gray.npy", "{d}/x.npy"], "not a .tdc/.tdcc stream"),
    (["decode", "--scale", "5/7", "{d}/gray.port.tdc", "{d}/x.npy"], "--scale must be M/8"),
    (["decode", "--scale", "2/8", "--preview", "{d}/gray.port.tdc", "{d}/x.npy"], "does not combine"),
    (["decode", "--rows", "9", "{d}/gray.port.tdc", "{d}/x.npy"], "--rows expects A:B"),
    (["decode", "--rows", "70:80", "{d}/gray.port.tdc", "{d}/x.npy"], "empty range"),
])
def test_what_waits_and_bad_input_are_clear_errors(files, capsys, argv, what):
    """Bad input fails in both CLIs with the same clear error (a missing
    .jpg: the coefficient import's IOError, where the library builds)."""
    from tpudct_torch.utils.jpegcoef import coef_io_available

    d = files
    if not (d / "gray.port.tdc").exists():
        assert CLI.main(["encode", "--device", "cpu", str(d / "gray.npy"), str(d / "gray.port.tdc")]) == 0
    capsys.readouterr()
    assert RCLI.main([a.format(d=d) for a in argv]) == 1
    want = capsys.readouterr().err
    assert CLI.main([a.format(d=d) for a in argv] + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    if argv[1].endswith(".jpg") and not coef_io_available():
        what = "needs the native JPEG library"
    else:
        assert err == want
    assert err.startswith("error: ") and pytest.importorskip("re").search(what, err), err


def test_color_refuses_a_q_table_file_like_reference(files):
    argv = ["encode", "--color", "--q-table-file", str(files / "q.txt"), str(files / "rgb.npy"), str(files / "x.tdcc")]
    with pytest.raises(SystemExit) as want:
        RCLI.main(argv)
    with pytest.raises(SystemExit) as got:
        CLI.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_no_card_and_no_device_raises(files, monkeypatch):
    """Nothing falls back to the CPU unasked."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["encode", str(files / "gray.npy"), str(files / "x.tdc")])


def test_entropy_specs_are_the_reference():
    for v in ("auto", "banded", "banded:4", "banded:4:rans", "banded::xz"):
        assert CLI._entropy_spec(v) == RCLI._entropy_spec(v)
    for bad in ("nope", "banded:0:banded", "banded:300", "banded:2:nope"):
        with pytest.raises(Exception) as want:
            RCLI._entropy_spec(bad)
        with pytest.raises(type(want.value), match=pytest.importorskip("re").escape(str(want.value))):
            CLI._entropy_spec(bad)
    for s in ("1/2", "3/4", "2/1", "5/8", "16/8"):
        assert CLI._parse_scale(s) == RCLI._parse_scale(s)
