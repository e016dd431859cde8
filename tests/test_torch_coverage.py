"""The port is complete: every public top-level name of the reference has a
same-named counterpart in the port.

One case per module of ``tpudct/`` (found by ``pkgutil``; the packages'
``__init__`` files are held by ``test_public_names_match_reference``), plus
``bench.py``, ``__graft_entry__.py`` and each driver of ``benchmarks/`` (its
counterpart: ``tpudct_torch/studies/`` of the same name).  Each case reads
the names with ``ast`` from both files' source, so no module is run by the
test: a public function, class or constant defined at the top level of the
reference module (inside a top-level ``if``/``try`` too) must be defined or
imported at the top level of its counterpart.  A driver of ``benchmarks/``
may run its work at its top level, where the port runs it in ``main()``: for
those cases a name defined in the body of the counterpart's ``main`` counts
too.

Every name the port leaves out on purpose stands in ``EXCLUDED`` with its
reason; an exclusion must name something the reference has and the port
lacks, so a stale one fails too.  A name added to the reference, or taken
from the port, fails its module's case until it is ported or excluded here.
"""

import ast
import importlib.util
import pathlib
import pkgutil

import pytest

import tpudct

ROOT = pathlib.Path(__file__).resolve().parents[1]

# reference module -> the port's module(s) holding its names, where the
# path differs from the reference's under tpudct_torch
PORT_MODULES = {
    "tpudct.kernels.hp_pallas": ("tpudct_torch.kernels.hp",),
    "tpudct.kernels.color_pallas": ("tpudct_torch.kernels.color",),
    "bench": ("tpudct_torch.bench", "tpudct_torch.selftest"),
    "__graft_entry__": ("tpudct_torch.entry",),
    "benchmarks.u8_perf": ("tpudct_torch.studies.u8_perf", "tpudct_torch.kernels.study"),
    "benchmarks.color_fused_ab": ("tpudct_torch.studies.color_fused_ab", "tpudct_torch.kernels.study"),
}

_LAYOUT = "MXU/lane layout: a block-diagonal K = 128 operand for the TPU's 128x128 matrix unit"
_SPEC = "PartitionSpec: a JAX sharding annotation; the port's meshes split tensors by rows"
_LANE = "the TPU's lane width, the unit of the studies' tile geometry sweeps (not ported: the tiles are inert)"
_KPAIR = "the chained-slope timer's K pair: the port times with CUDA events (utils.timing), where it is inert"
_CHAIN = "scaled_ab's chained-slope pass: an XOR feedback chain to time through the TPU's remote dispatch"
_SIDE = "the script's fixed side: the port's main() takes it as `size`"
EXCLUDED = {
    "tpudct.constants": {"block_diag_T": _LAYOUT, "block_diag_Ts": _LAYOUT},
    "tpudct.ops.scaled": {"scaled_idct2_blocks": "never called in the repo"},
    "tpudct.models.dispatch": {
        "roundtrip_gray_jax": "jit-only alias: a traceable roundtrip_gray_auto for jax.jit callers",
    },
    "tpudct.parallel.mesh": {"band_spec": _SPEC, "grid_spec": _SPEC},
    "tpudct.parallel.sharding": {"batch_spec": _SPEC, "rgb_band_spec": _SPEC, "rgb_grid_spec": _SPEC},
    "benchmarks.color_variants2": {"K_PAIR": _KPAIR},
    "benchmarks.enc_variants": {"KP": _KPAIR, "LANE": _LANE},
    "benchmarks.inv_formulations": {"LANE": _LANE},
    "benchmarks.rt_split_ab": {"KP": _KPAIR},
    "benchmarks.u8_variants": {"LANE": _LANE},
    "benchmarks.scaled_ab": {
        "K_PAIR": _KPAIR, "feedback": _CHAIN, "feedback_only": _CHAIN, "fb": _CHAIN, "fused_op": _CHAIN,
        "composed_op": _CHAIN, "H": _SIDE, "W": _SIDE,
    },
}


def _reference_modules() -> list:
    mods = [m.name for m in pkgutil.walk_packages(tpudct.__path__, "tpudct.") if not m.ispkg]
    drivers = [f"benchmarks.{p.stem}" for p in sorted((ROOT / "benchmarks").glob("*.py"))]
    return sorted(mods) + ["bench", "__graft_entry__"] + drivers


def _source(module: str) -> pathlib.Path:
    """The file of ``module``, found without running it."""
    if module in ("bench", "__graft_entry__") or module.startswith("benchmarks."):
        return ROOT / f"{module.replace('.', '/')}.py"
    spec = importlib.util.find_spec(module)
    assert spec is not None and spec.origin, f"no module {module}"
    return pathlib.Path(spec.origin)


def _defined(body) -> set:
    """Names a module body defines at its top level (functions, classes,
    assignments), descending into top-level if/try blocks."""
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.If, ast.Try)):
            names |= _defined(node.body) | _defined(node.orelse)
            for block in getattr(node, "handlers", []):
                names |= _defined(block.body)
            names |= _defined(getattr(node, "finalbody", []))
    return names


def _imported(body) -> set:
    return {(a.asname or a.name).split(".")[0] for node in body if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in node.names}


def _main_body(body) -> list:
    """The body of the module's top-level ``main`` function ([] without one)."""
    return next((node.body for node in body if isinstance(node, ast.FunctionDef) and node.name == "main"), [])


def _public(names: set) -> set:
    return {n for n in names if not n.startswith("_")}


def test_the_cases_cover_the_reference():
    mods = _reference_modules()
    assert {"tpudct.kernels.hp_pallas", "tpudct.cli", "tpudct.parallel.ring", "tpudct.utils.jpegcoef",
            "bench", "__graft_entry__", "benchmarks.partial_at_scale", "benchmarks.u8_perf"} <= set(mods)
    assert len([m for m in mods if m.startswith("benchmarks.")]) == 15
    assert set(EXCLUDED) <= set(mods) and set(PORT_MODULES) <= set(mods)


@pytest.mark.parametrize("module", _reference_modules())
def test_every_public_name_is_ported(module):
    ref = _public(_defined(ast.parse(_source(module).read_text()).body))
    ported = set()
    default = (f"tpudct_torch.studies.{module.split('.')[1]}" if module.startswith("benchmarks.")
               else "tpudct_torch" + module[len("tpudct"):])
    for port in PORT_MODULES.get(module, (default,)):
        body = ast.parse(_source(port).read_text()).body
        ported |= _defined(body) | _imported(body)
        if module.startswith("benchmarks."):
            ported |= _defined(_main_body(body))
    excluded = EXCLUDED.get(module, {})
    assert all(excluded.values()), "every exclusion states its reason"
    stale = sorted(set(excluded) - (ref - ported))
    assert not stale, f"{module}: excluded but in the port, or not in the reference: {stale}"
    missing = sorted(ref - ported - set(excluded))
    assert not missing, f"{module}: the port lacks {missing}"
