"""Every kernel launch of ``vits_tpu_torch/ops/cuda`` runs on its tensors' device.

The C library keys its per-device state on ``cudaGetDevice`` (the raised
shared-memory ceilings, kernel 5's second stream, kernel 6's capture stream),
and every host thread starts at device 0. So each call into ``library()`` must
sit inside ``with on_device(t):`` (``ops/cuda/__init__.py``): without it a
tensor on ``cuda:1`` launches into device 0's state, which one card cannot
show. These checks read the sources, so they hold on the CPU.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
WRAPPERS = sorted((REPO / "vits_tpu_torch" / "ops" / "cuda").glob("*.py"))
# reads a table of strings; no device state
UNGUARDED = {"vk_error_string"}


def _parents(tree: ast.AST) -> dict:
    return {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}


def _is_library_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "library")


def _library_names(func: ast.AST) -> set[str]:
    """Local names bound to ``library()`` in a function (``lib = library()``)."""
    return {target.id for node in ast.walk(func) if isinstance(node, ast.Assign)
            and _is_library_call(node.value) for target in node.targets
            if isinstance(target, ast.Name)}


def _guarded(node: ast.AST, parents: dict) -> bool:
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and isinstance(item.context_expr.func, ast.Name)
                and item.context_expr.func.id == "on_device" for item in node.items):
            return True
    return False


def library_calls(path: Path) -> list[tuple[str, int, bool]]:
    """(entry point, line, guarded) of every ``vk_*`` call into the library in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = _parents(tree)
    found = []
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        names = _library_names(func)
        for node in ast.walk(func):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("vk_")):
                continue
            owner = node.func.value
            if _is_library_call(owner) or (isinstance(owner, ast.Name) and owner.id in names):
                found.append((node.func.attr, node.lineno, _guarded(node, parents)))
    return found


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.name)
def test_every_library_call_runs_under_its_device(path):
    calls = [c for c in library_calls(path) if c[0] not in UNGUARDED]
    unguarded = [f"{path.name}:{line} {name}" for name, line, ok in calls if not ok]
    assert not unguarded, unguarded


def test_the_scan_sees_every_entry_point():
    """Every C entry point the package binds is launched somewhere the scan looks."""
    from vits_tpu_torch.ops.cuda import _SIGNATURES

    seen = {name for path in WRAPPERS for name, _, _ in library_calls(path)}
    # vk_graph_destroy is handed to weakref.finalize, not called in place
    assert seen >= set(_SIGNATURES) - {"vk_graph_destroy"}, set(_SIGNATURES) - seen


def test_scan_flags_a_call_outside_the_guard(tmp_path):
    src = tmp_path / "wrapper.py"
    src.write_text(
        "def f(x):\n"
        "    lib = library()\n"
        "    with on_device(x):\n"
        "        lib.vk_conv(1)\n"
        "    library().vk_wave(2)\n"
        "    with lock, on_device(x):\n"
        "        library().vk_flow_run(3)\n")
    assert sorted(library_calls(src), key=lambda c: c[1]) == [
        ("vk_conv", 4, True), ("vk_wave", 5, False), ("vk_flow_run", 7, True)]


def test_no_csrc_static_holds_one_value_for_every_device():
    """A mutable ``static`` in ``csrc/`` is a table indexed by device, never one
    value that the first device to call sets for all of them."""
    statics = []
    for path in sorted((REPO / "vits_tpu_torch" / "csrc").glob("*.cu*")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("//")[0]
            if re.search(r"\bstatic\s+(?!constexpr\b|inline\b|__device__\b|__global__\b)\w",
                         code) and "(" not in code.split("=")[0]:
                statics.append((f"{path.name}:{i}", code.strip()))
    per_device = [s for s in statics if re.search(r"\[\s*64\s*\]", s[1])]
    assert statics and per_device == statics, [s for s in statics if s not in per_device]
