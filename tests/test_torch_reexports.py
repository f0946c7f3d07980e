"""What the port's packages bind, against the JAX package's ``__init__``s.

Every public name that an ``__init__.py`` of ``qcnn_tpu/`` binds (imports,
definitions, assignments; ``__version__``) is an attribute of the port's
package at the same place. The JAX side is read with ``ast``, so no jax is
imported. Left out: ``ops/pallas``, whose Pallas wrappers have CUDA
counterparts under another name in ``ops/cuda``; private names (``_SO``,
``_loader``) need none.
"""

import ast
import importlib
import pathlib

import pytest
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "qcnn_tpu"
NOT_PORTED_HERE = {("ops", "pallas")}


def _packages() -> list[tuple[str, ...]]:
    return [f.parent.relative_to(JAX_ROOT).parts
            for f in sorted(JAX_ROOT.rglob("__init__.py"))
            if f.parent.relative_to(JAX_ROOT).parts not in NOT_PORTED_HERE]


def _bound_names(path: pathlib.Path) -> set[str]:
    """The public names that the module's top level binds."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def test_every_jax_package_init_is_read():
    parts = _packages()
    assert () in parts and ("models",) in parts and ("utils",) in parts
    assert ("parallel",) in parts
    assert len(parts) == 13


@pytest.mark.parametrize("parts", _packages(), ids=lambda p: ".".join(p)
                         or "qcnn_tpu")
def test_port_binds_what_the_jax_package_exports(parts):
    names = _bound_names(JAX_ROOT.joinpath(*parts, "__init__.py"))
    port = importlib.import_module(".".join(("qcnn_tpu_torch", *parts)))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_the_graft_entry_import_and_the_version():
    from qcnn_tpu_torch.models import (
        get_model,
        load_alexnet_reference,
        make_forward_fn,
    )
    from qcnn_tpu_torch.utils import StopWatch
    import qcnn_tpu_torch

    assert qcnn_tpu_torch.__version__ == "0.1.0"
    assert get_model("alexnet").name == "AlexNet"
    assert callable(load_alexnet_reference) and callable(make_forward_fn)
    assert StopWatch().count == 0
