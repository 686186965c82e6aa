"""The port (repro_torch) stands apart from the reference package (repro).

* no file of the port, and no line of ``chip_smoke.py``, imports JAX or
  the reference package: the port runs on a machine without JAX;
* the port's TPC-H generator gives the reference generator's arrays, so
  the two engines can be held to one data set;
* the reference's own linter (``repro.analysis``) finds nothing in the
  port: every lock rule applies to it too.
"""

import ast
import os

import numpy as np
import pytest

from repro.analysis import run_lint
from repro.data import tpch as ref_tpch
from repro_torch.core.types import DBType
from repro_torch.data import tpch as port_tpch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _absolute_imports(path):
    """Top-level package of every absolute import in ``path`` (relative
    imports stay inside the port), plus the literal argument of every
    ``__import__`` / ``importlib.import_module`` call."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("__import__", "import_module"):
                yield node.lineno, node.args[0].value.split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert os.path.join(PORT, "core", "parallel.py") in files
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _absolute_imports(path)
           if mod in FORBIDDEN]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_scan_sees_forbidden_imports(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                 "from . import ok\nimportlib.import_module('repro.data')\n")
    assert [m for _, m in _absolute_imports(str(p))] == \
        ["jax", "repro", "repro"]


@pytest.mark.parametrize("sf,seed", [(0.01, 7), (0.002, 3)])
def test_generator_matches_reference(sf, seed):
    ref = ref_tpch.generate(sf, seed)
    port = port_tpch.generate(sf, seed)
    assert list(port) == list(ref)
    for name, (arrays, types, scales) in ref.items():
        p_arrays, p_types, p_scales = port[name]
        assert list(p_arrays) == list(arrays), name
        for c, a in arrays.items():
            b = p_arrays[c]
            assert b.dtype == a.dtype, (name, c)
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{c}")
        assert {c: DBType(t.value) for c, t in types.items()} == p_types
        assert p_scales == scales


def test_reference_linter_finds_nothing_in_port():
    findings = run_lint([PORT, os.path.join(ROOT, "chip_smoke.py")])
    assert findings == [], "\n".join(str(f) for f in findings)
