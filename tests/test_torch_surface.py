"""The port's public surface covers the JAX package's.

For every module of ``srsran_project_23_5_tpu`` the module of the same
path in ``srsran_project_23_5_tpu_torch`` exists and has every public
top-level name the JAX module defines (functions, classes, constants; not
the names it imports), and each numeric constant has the same value.  The
JAX modules are read as source, not imported: importing them would build
the JAX package's native libraries in place, which races under xdist.

Exceptions: the modules that are not ported (ROADMAP's not-to-port list:
TPU layout workarounds, the XLA cache and program store, the XLA decoder,
an empty package) and the two Pallas kernels, whose modules are replaced
by the CUDA kernels' wrappers without the Pallas tile layout.
"""
import ast
import importlib
import numbers
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "srsran_project_23_5_tpu"

NOT_PORTED = {
    "ops/cplx.py", "ops/devconst.py",     # the TPU's complex layout
    "utils/cache.py", "utils/program_store.py",   # XLA cache, jax.export
    "ops/ldpc/decoder.py",                # the XLA decoder (Pallas semantics)
    "phy/support/__init__.py",            # an empty package
}
# Pallas module → (its CUDA wrapper, the Pallas tile layout it drops)
REPLACED = {
    "ops/ldpc/encoder_pallas.py": ("ops/ldpc/encoder_cuda.py", {"B_TILE"}),
    "ops/ldpc/decoder_pallas.py": ("ops/ldpc/decoder_cuda.py",
                                   {"B_TILE", "STORE"}),
}
MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                 if str(p.relative_to(JAX_PKG)) not in NOT_PORTED)


def _public(path: Path) -> tuple[list[str], dict]:
    """The public names a module's top level defines, and the values of
    its numeric constants that evaluate from literals and earlier
    constants."""
    names, consts = [], {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names += [n.id for n in ast.walk(t)
                          if isinstance(n, ast.Name)]
            if (len(targets) == 1 and isinstance(targets[0], ast.Name)
                    and node.value is not None):
                try:
                    value = eval(compile(ast.Expression(node.value), "<c>",
                                         "eval"), {"__builtins__": {}},
                                 dict(consts))
                except Exception:
                    continue
                if (isinstance(value, numbers.Number)
                        and not isinstance(value, bool)):
                    consts[targets[0].id] = value
    return ([n for n in dict.fromkeys(names) if not n.startswith("_")],
            {k: v for k, v in consts.items() if not k.startswith("_")})


def _module_name(rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["srsran_project_23_5_tpu_torch", *parts])


def test_the_lists_name_real_modules():
    for rel in NOT_PORTED | set(REPLACED):
        assert (JAX_PKG / rel).exists(), rel
    assert len(MODULES) > 100


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_the_public_names(rel):
    names, consts = _public(JAX_PKG / rel)
    port_rel, dropped = REPLACED.get(rel, (rel, set()))
    port = importlib.import_module(_module_name(port_rel))
    missing = [n for n in names if n not in dropped and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    differ = {n: (v, getattr(port, n)) for n, v in consts.items()
              if n not in dropped and getattr(port, n) != v}
    assert not differ, f"{port.__name__}: JAX value, port value {differ}"
