"""The coefficient-level verbs of ``python -m tpudct_torch`` (``decode`` of
a ``.jpg``, ``transcode``, ``edit``, ``batch --transcode``, ``unbatch
--transcode``) against ``tpudct.cli`` on the CPU (``--device cpu``: the
kernels' plain twins).

Both CLIs run in process on the same small JPEGs (a 43x61 gray at quality
77, a 48x64 RGB at 4:2:0 and quality 85, a 64x64 RGB at 4:4:4) and the
streams made from them.  What must agree, and how closely:
- the JSON records: key for key, the paths aside (each CLI writes its own
  files) and the ``ms`` timings (the same keys);
- the files (``.tdc``, ``.tdcc``, ``.jpg``, manifests): byte for byte;
- the decoded pixels of an imported JPEG: the classes of ROADMAP §C.  A
  quality-77/85 table makes coefficients beyond int8, so the gray decode
  runs the f32-literal dct core (B6's class: +-1 at ties on at most 0.2%
  of pixels) and the color decode its f32 path (the color split/merge
  class, +-1 on at most 0.5%); each count is printed.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import tpudct.cli as RCLI
import tpudct_torch.cli as CLI
from tpudct.utils import imageio as RIO
from tpudct.utils import jpegcoef as RJ
from tpudct_torch.utils import jpegcoef as J

from test_torch_jpegcoef import registries  # noqa: F401  (the shared registry fixture)

pytestmark = [
    pytest.mark.skipif(not (J.coef_io_available() and RJ.coef_io_available()),
                       reason="native coefficient I/O unavailable (no libjpeg headers)"),
    pytest.mark.usefixtures("registries"),
]


@pytest.fixture
def jpgs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float64)
    smooth = np.stack([128 + 60 * np.sin(yy / 7), 128 + 50 * np.cos(xx / 9), (yy + xx) * 1.5], -1)
    RIO.save_jpeg(tmp_path / "g.jpg", rng.normal(128, 40, (43, 61)).clip(0, 255).astype(np.uint8), quality=77)
    RIO.save_jpeg(tmp_path / "c.jpg", (smooth[:48] + rng.normal(0, 8, (48, 64, 3))).clip(0, 255).astype(np.uint8),
                  quality=85)
    Image.fromarray(smooth.clip(0, 255).astype(np.uint8)).save(tmp_path / "c444.jpg", "JPEG", quality=90,
                                                              subsampling=0)
    return tmp_path


def _norm(text: str, d: Path) -> str:
    """`text` with the paths under `d` relative and the side's name
    ("mine", "ref") at their start dropped."""
    for who in ("mine", "ref"):
        text = text.replace(f"{d}/{who}", "X")
    return text.replace(str(d), "D")


def _both(capsys, d: Path, argv: list, rc: int = 0, device: bool = False) -> tuple:
    """`argv` with {d} and {who} filled, through the reference ("ref") and
    the port ("mine"); both exit codes must be `rc`; their records, paths
    normalized, must be equal apart from ``ms`` timings.  Returns the
    port's records and stderr texts."""
    fill = lambda who: [a.format(d=d, who=who) for a in argv]  # noqa: E731
    capsys.readouterr()  # what earlier set-up calls printed
    assert RCLI.main(fill("ref")) == rc
    ref = capsys.readouterr()
    assert CLI.main(fill("mine") + (["--device", "cpu"] if device else [])) == rc
    mine = capsys.readouterr()
    got, want = ([json.loads(_norm(line, d)) for line in o.out.splitlines() if line.startswith("{")]
                 for o in (mine, ref))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pop("ms", {}).keys() == w.pop("ms", {}).keys()
        assert g == w
    if rc:
        assert _norm(mine.err, d) == _norm(ref.err, d) and mine.err.startswith("error: "), (mine.err, ref.err)
    return got, mine.err


def _same_file(d: Path, name: str) -> bytes:
    mine, ref = (d / name.format(who=who) for who in ("mine", "ref"))
    assert mine.read_bytes() == ref.read_bytes(), name
    return mine.read_bytes()


def _same_pixels(capsys, label: str, a: np.ndarray, b: np.ndarray, share: float) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, label
    dd = np.abs(a.astype(np.int16) - b)
    n = int((dd > 0).sum())
    with capsys.disabled():
        print(f"{label}: {n} of {a.size} pixels differ (max {int(dd.max())})")
    assert dd.max() <= 1 and n <= share * a.size, label


DECODES = {
    "full": [],
    "scale-4/8": ["--scale", "4/8"],
    "scale-3/8": ["--scale", "3/8"],
    "planes-6": ["--planes", "6"],
    "preview": ["--preview"],
    "rows": ["--rows", "8:30"],
    "grayscale": ["--grayscale"],
}


@pytest.mark.parametrize("src", ["g.jpg", "c.jpg", "c444.jpg"])
@pytest.mark.parametrize("mode", list(DECODES))
def test_decode_jpg_is_the_reference(jpgs, capsys, src, mode):
    """``decode in.jpg``: the coefficient import at codec raw, then each
    decode mode, as the reference runs it; the raster within the class."""
    _both(capsys, jpgs, ["decode", *DECODES[mode], f"{{d}}/{src}", "{d}/{who}.npy"], device=True)
    mine, ref = (np.load(jpgs / f"{who}.npy") for who in ("mine", "ref"))
    _same_pixels(capsys, f"decode {src} {mode}", mine, ref, 0.005 if src.startswith("c") else 0.002)
    if mode == "full" and src == "g.jpg":  # the import decodes within 1 of libjpeg's pixels
        assert np.abs(mine.astype(int) - RIO.load_jpeg(jpgs / src)).max() <= 1


TRANSCODES = {
    "jpg->tdc": (["g.jpg", "{who}.tdc"], []),
    "jpg->tdc-rans": (["g.jpg", "{who}.tdc"], ["--entropy", "rans"]),
    "jpg->tdc-banded": (["g.jpg", "{who}.tdc"], ["--entropy", "banded:4:huffman"]),
    "jpg->tdcc": (["c.jpg", "{who}.tdcc"], []),
    "jpg->tdcc-444-xz": (["c444.jpg", "{who}.tdcc"], ["--entropy", "xz"]),
}


@pytest.mark.parametrize("name", list(TRANSCODES))
def test_transcode_import_is_the_reference(jpgs, capsys, name):
    files, flags = TRANSCODES[name]
    _both(capsys, jpgs, ["transcode", *flags, *(f"{{d}}/{f}" for f in files)])
    _same_file(jpgs, files[1])


EXPORTS = {"plain": [], "optimize": ["--optimize"], "progressive": ["--progressive"],
           "arithmetic": ["--arithmetic"], "progressive-arithmetic": ["--progressive", "--arithmetic"]}


@pytest.mark.parametrize("src", ["g.jpg", "c.jpg"])
@pytest.mark.parametrize("flags", list(EXPORTS))
def test_transcode_export_is_the_reference(jpgs, capsys, src, flags):
    """tdc -> jpg: the same bytes, and jpg -> tdc -> jpg gives the file's
    own coefficients back, bit for bit."""
    ext = ".tdcc" if src.startswith("c") else ".tdc"
    assert CLI.main(["transcode", str(jpgs / src), str(jpgs / f"s{ext}")]) == 0
    _both(capsys, jpgs, ["transcode", *EXPORTS[flags], f"{{d}}/s{ext}", "{d}/{who}.jpg"])
    _same_file(jpgs, "{who}.jpg")
    back, orig = (J.read_jpeg_coefficients(p) for p in (jpgs / "mine.jpg", jpgs / src))
    for a, b in zip(back["comps"], orig["comps"]):
        assert np.array_equal(a["map"], b["map"]) and np.array_equal(a["qtab"], b["qtab"])


@pytest.mark.parametrize("src,entropy", [("g.jpg", "huffman"), ("g.jpg", "banded"), ("c.jpg", "rans"),
                                         ("c.jpg", "banded::spectral")])
def test_transcode_restage_is_the_reference(jpgs, capsys, src, entropy):
    """tdc -> tdc re-codes the entropy stage alone; a banded source under
    ``banded[::inner]`` one segment at a time; the TDCM chunk carries
    over."""
    ext = ".tdcc" if src.startswith("c") else ".tdc"
    assert CLI.main(["transcode", "--entropy", "banded:3:raw", str(jpgs / src), str(jpgs / f"s{ext}")]) == 0
    _both(capsys, jpgs, ["transcode", "--entropy", entropy, f"{{d}}/s{ext}", f"{{d}}/{{who}}{ext}"])
    out = _same_file(jpgs, f"{{who}}{ext}")
    assert J._extract_metadata(out) == J._extract_metadata((jpgs / f"s{ext}").read_bytes())


EDITS = {
    "jpg->jpg rot90": (["c.jpg", "{who}.jpg"], ["--op", "rot90"]),
    "jpg->jpg transpose optimize": (["c444.jpg", "{who}.jpg"], ["--op", "transpose", "--optimize"]),
    "jpg->tdcc crop hflip": (["c.jpg", "{who}.tdcc"], ["--crop", "16", "0", "32", "48", "--op", "hflip"]),
    "jpg->tdc grayscale vflip": (["c444.jpg", "{who}.tdc"], ["--grayscale", "--op", "vflip"]),
    "tdc->tdc transpose": (["g.tdc", "{who}.tdc"], ["--op", "transpose", "--entropy", "rans"]),
    "tdcc->jpg rot180 progressive": (["c.tdcc", "{who}.jpg"], ["--op", "rot180", "--progressive"]),
    "tdcc->tdc grayscale": (["c.tdcc", "{who}.tdc"], ["--grayscale"]),
}


@pytest.mark.parametrize("name", list(EDITS))
def test_edit_is_the_reference(jpgs, capsys, name):
    for src in ("g", "c"):
        assert CLI.main(["transcode", str(jpgs / f"{src}.jpg"), str(jpgs / f"{src}.tdc{'c' * (src == 'c')}")]) == 0
    files, flags = EDITS[name]
    _both(capsys, jpgs, ["edit", *flags, *(f"{{d}}/{f}" for f in files)])
    _same_file(jpgs, files[1])


@pytest.mark.parametrize("argv", [
    ["edit", "{d}/g.jpg", "{d}/{who}.jpg"],  # nothing to do
    ["edit", "--op", "hflip", "{d}/g.jpg", "{d}/{who}.jpg"],  # width 61: a partial block
    ["edit", "--op", "rot90", "{d}/c.jpg", "{d}/{who}.tdc"],  # a color stream to .tdc
    ["edit", "--optimize", "--op", "vflip", "{d}/c.jpg", "{d}/{who}.tdcc"],
    ["transcode", "--optimize", "{d}/g.jpg", "{d}/{who}.tdc"],
    ["transcode", "{d}/c.jpg", "{d}/{who}.tdc"],  # a color JPEG to .tdc
    ["transcode", "{d}/g.jpg", "{d}/{who}.png"],
    ["decode", "{d}/missing.jpg", "{d}/{who}.npy"],
], ids=["nothing", "partial-block", "color-to-tdc", "optimize-to-tdcc", "transcode-optimize",
        "transcode-color-to-tdc", "transcode-png", "decode-missing"])
def test_refusals_are_the_reference(jpgs, capsys, argv):
    _both(capsys, jpgs, argv, rc=1, device=argv[0] == "decode")


def test_the_verbs_need_the_library_for_jpg(jpgs, capsys, monkeypatch):
    """Without the native JPEG library (TPUDCT_NO_NATIVE_JPEG) every .jpg
    end refuses with a ValueError, as the reference's do, and the .tdc
    restage still runs."""
    monkeypatch.setenv("TPUDCT_NO_NATIVE_JPEG", "1")
    for argv in (["decode", "--device", "cpu", "{d}/g.jpg", "{d}/x.npy"], ["transcode", "{d}/g.jpg", "{d}/x.tdc"],
                 ["edit", "--op", "vflip", "{d}/g.jpg", "{d}/x.jpg"], ["batch", "--transcode", "{d}", "{d}/out"],
                 ["unbatch", "--transcode", "--ext", ".jpg", "{d}", "{d}/out"]):
        assert CLI.main([a.format(d=jpgs) for a in argv]) == 1
        assert "needs the native JPEG library" in capsys.readouterr().err, argv
    monkeypatch.delenv("TPUDCT_NO_NATIVE_JPEG")
    assert CLI.main(["transcode", str(jpgs / "g.jpg"), str(jpgs / "g.tdc")]) == 0
    monkeypatch.setenv("TPUDCT_NO_NATIVE_JPEG", "1")
    assert CLI.main(["transcode", "--entropy", "raw", str(jpgs / "g.tdc"), str(jpgs / "g2.tdc")]) == 0


def _manifest(d: Path) -> dict:
    recs = [json.loads(line) for line in (d / "manifest.jsonl").read_text().splitlines()]
    return {r["file"]: r for r in recs}


def test_batch_and_unbatch_transcode_are_the_reference(jpgs, capsys):
    """``batch --transcode`` over the three JPEGs and a corrupt one, each on
    its thread pool: the same .tdc/.tdcc files, manifest records
    (``"transcode": true``, ``src_bytes``) and summary; a rerun skips them;
    ``unbatch --transcode`` restores the same .jpg bytes, and the file's
    own coefficients."""
    src = jpgs / "in"
    src.mkdir()
    for f in ("g.jpg", "c.jpg", "c444.jpg"):
        (src / f).write_bytes((jpgs / f).read_bytes())
    (src / "bad.jpg").write_bytes(b"not a jpeg at all")
    got, _ = _both(capsys, jpgs, ["batch", "--transcode", "--entropy", "huffman", "{d}/in", "{d}/{who}"],
                   device=True)
    assert got[0]["transcoded"] == 3 and got[0]["failed"] == 1 and got[0]["saved_pct"] is not None
    mine, ref = (_manifest(jpgs / who) for who in ("mine", "ref"))
    assert mine == ref and mine["g.jpg"]["transcode"] is True and mine["g.jpg"]["src_bytes"] > 0
    assert mine["bad.jpg"]["error_kind"] == "stream"
    for f in ("g.jpg.tdc", "c.jpg.tdcc", "c444.jpg.tdcc"):
        _same_file(jpgs, "{who}/" + f)
    got, _ = _both(capsys, jpgs, ["batch", "--transcode", "--entropy", "huffman", "{d}/in", "{d}/{who}"],
                   device=True)
    assert got[0]["skipped"] == 4 and got[0]["transcoded"] == 0

    (jpgs / "mine" / "bad.tdc").write_bytes(b"TDC4 corrupt")
    (jpgs / "ref" / "bad.tdc").write_bytes(b"TDC4 corrupt")
    for flags in ([], ["--optimize"]):
        _both(capsys, jpgs, ["unbatch", "--transcode", *flags, "--ext", ".jpg", "{d}/{who}",
                             "{d}/{who}-out" + "".join(flags)], device=True)
        mine, ref = (_manifest(jpgs / f"{who}-out{''.join(flags)}") for who in ("mine", "ref"))
        assert {k: {**v, "error": None} for k, v in mine.items()} == {k: {**v, "error": None}
                                                                       for k, v in ref.items()}
        assert mine["g.jpg.tdc"] == {"file": "g.jpg.tdc", "out": "g.jpg.tdc.jpg", "transcode": True}
        for f in ("g.jpg.tdc.jpg", "c.jpg.tdcc.jpg", "c444.jpg.tdcc.jpg"):
            _same_file(jpgs, "{who}-out" + "".join(flags) + "/" + f)
    back = J.read_jpeg_coefficients(jpgs / "mine-out" / "c.jpg.tdcc.jpg")
    for a, b in zip(back["comps"], J.read_jpeg_coefficients(jpgs / "c.jpg")["comps"]):
        assert np.array_equal(a["map"], b["map"])
