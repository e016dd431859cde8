"""``tpudct_torch.utils.coefops`` (lossless coefficient-domain flips,
rotations, transposes, crops and grayscale) against
``tpudct.utils.coefops`` on the CPU.

An edit permutes and negates stored integers, so everything must be equal:
the edited maps, the q-table names a transposing op registers (carried in
the bytes as embedded tables) and the re-serialized bytes, for every op in
``OPS``, compositions, crops and ``--grayscale``, on gray streams (haweel,
and dct with a non-symmetric custom table) and on 4:2:0, 4:2:2 and 4:4:4
streams, and on streams imported from JPEGs (MCU padding, a TDCM chunk);
the refusals (misaligned flips and crops, a transposed 4:2:2, unknown ops)
with the same exception type and message.  Maps are small (up to 64x64).
"""

import numpy as np
import pytest

from tpudct.utils import coefops as RC
from tpudct_torch.utils import coefops as C
from tpudct_torch.utils import serialize as S

from test_torch_jpegcoef import jpegs, registries  # noqa: F401  (the shared fixtures)


def _coef_io() -> bool:
    from tpudct.utils.jpegcoef import coef_io_available
    from tpudct_torch.utils.jpegcoef import coef_io_available as mine

    return coef_io_available() and mine()


EDITS = [([op], None, False) for op in C.OPS] + [
    (["rot90", "hflip"], None, False),
    (["transpose", "rot270", "vflip"], None, False),
    ([], (8, 16, 40, 17), False),
    (["rot180"], (16, 0, 32, 32), False),
    ([], None, True),
    (["rot90"], None, True),
]


def _ids(e):
    ops, crop, gray = e
    return "+".join(ops) + (f"-crop{'x'.join(map(str, crop))}" if crop else "") + ("-gray" if gray else "")


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-60, 61, shape).astype(np.float32)


def _streams() -> dict:
    """name -> .tdc/.tdcc bytes (built after the registry reset)."""
    from tpudct_torch.constants import register_q_table
    import tpudct.constants as RK

    table = np.arange(1, 65, dtype=np.float32).reshape(8, 8)  # not symmetric
    name = register_q_table(table)
    assert RK.register_q_table(table) == name
    out = {
        "gray-haweel": S.coefficients_to_bytes(_ints((64, 48), 0), orig_shape=(64, 48)),
        "gray-dct-custom": S.coefficients_to_bytes(_ints((64, 64), 1), orig_shape=(64, 64), transform="dct",
                                                   q_table=name, codec="huffman"),
    }
    for mode, cshape in (("420", (32, 32)), ("422", (64, 32)), (False, (64, 64))):
        planes = {"y": _ints((64, 64), 2), "cb": _ints(cshape, 3), "cr": _ints(cshape, 4)}
        meta = {"orig_shape": (64, 64), "chroma_shape": cshape, "subsample": mode}
        out[f"color-{mode or '444'}"] = S.color_to_bytes(planes, meta, codec="raw")
    return out


@pytest.mark.parametrize("edit", EDITS, ids=_ids)
@pytest.mark.parametrize("name", ["gray-haweel", "gray-dct-custom", "color-420", "color-422", "color-444"])
def test_edit_stream_is_the_reference(registries, name, edit):
    import tpudct.constants as RK
    import tpudct_torch.constants as PK

    data = _streams()[name]
    ops, crop, gray = edit
    try:
        want = RC.edit_stream(data, ops, crop=crop, codec="auto", grayscale=gray)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            C.edit_stream(data, ops, crop=crop, codec="auto", grayscale=gray)
        assert str(got.value) == str(e)
        return
    got = C.edit_stream(data, ops, crop=crop, codec="auto", grayscale=gray)
    assert got == want
    assert sorted(PK.Q_TABLES) == sorted(RK.Q_TABLES)  # the same transposed tables, by name


@pytest.mark.skipif(not _coef_io(), reason="native coefficient I/O unavailable (no libjpeg headers)")
@pytest.mark.parametrize("op", C.OPS)
@pytest.mark.parametrize("name", ["gray", "420", "422", "444"])
def test_edits_of_imported_jpegs_are_the_reference(jpegs, registries, name, op):
    """Imported streams carry MCU padding (trimmed first) and, for the
    reference-encoded ones, the file's tables; the TDCM chunk survives."""
    from tpudct.utils import jpegcoef as RJ

    data = RJ.import_jpeg(jpegs[name], codec="raw")
    try:
        want = RC.edit_stream(data, [op], codec="raw")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            C.edit_stream(data, [op], codec="raw")
        assert str(got.value) == str(e)
        return
    assert C.edit_stream(data, [op], codec="raw") == want


@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas", "dct", "cb2011"])
def test_flip_sign_diag_is_the_reference(transform):
    got, want = C.flip_sign_diag(transform), RC.flip_sign_diag(transform)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("fn", ["hflip_map", "vflip_map", "transpose_map"])
def test_map_ops_are_the_reference(fn):
    c = _ints((24, 40), 7).astype(np.int16)
    args = (c,) if fn == "transpose_map" else (c, "haweel")
    got, want = getattr(C, fn)(*args), getattr(RC, fn)(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("call", [
    lambda m: m.apply_op_map(np.zeros((16, 16)), (16, 13), "hflip", "haweel"),
    lambda m: m.apply_op_map(np.zeros((16, 16)), (11, 16), "vflip", "haweel"),
    lambda m: m.apply_op_map(np.zeros((16, 16)), (11, 16), "rot90", "haweel"),
    lambda m: m.apply_op_map(np.zeros((16, 16)), (16, 13), "rot270", "haweel"),
    lambda m: m.apply_op_map(np.zeros((16, 16)), (16, 16), "spin", "haweel"),
    lambda m: m.crop_map(np.zeros((16, 16)), (16, 16), 4, 0, 8, 8),
    lambda m: m.crop_map(np.zeros((16, 16)), (16, 16), 8, 8, 9, 8),
    lambda m: m.edit_stream(b"", ["spin"]),
], ids=["hflip", "vflip", "rot90", "rot270", "unknown", "crop-origin", "crop-bounds", "stream-unknown"])
def test_refusals_are_the_reference(call):
    with pytest.raises(ValueError) as want:
        call(RC)
    with pytest.raises(ValueError) as got:
        call(C)
    assert str(got.value) == str(want.value)


def test_grayscale_of_a_gray_stream_passes_through(registries):
    data = _streams()["gray-haweel"]
    assert C.to_grayscale(data) == RC.to_grayscale(data) == data
    y = C.to_grayscale(_streams()["color-420"], codec="raw")
    assert y == RC.to_grayscale(_streams()["color-420"], codec="raw") and not S.is_color_stream(y)


def test_flips_decode_to_flipped_pixels_exactly(registries):
    """decode(edit(op)) equals op(decode) for the flips on the port's hp
    pipeline (plain twins here): a flip permutes blocks and negates odd
    rows/columns, so each decoded block is the mirrored one bit for bit."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.models.dispatch import decode_gray_auto

    data = _streams()["gray-haweel"]
    p, cfg = get_pipeline("hp"), CodecConfig()
    base = np.asarray(decode_gray_auto(p, S.bytes_to_coefficients(data)[0], cfg, (64, 48), device="cpu"))
    for op, fn in (("hflip", lambda a: a[:, ::-1]), ("vflip", lambda a: a[::-1]),
                   ("rot180", lambda a: a[::-1, ::-1])):
        c = S.bytes_to_coefficients(C.edit_stream(data, [op]))[0]
        assert np.array_equal(np.asarray(decode_gray_auto(p, c, cfg, (64, 48), device="cpu")), fn(base)), op
