"""The launch path's signature tables against the C sources they call.

Each wrapper in ``alpha_zero_tpu_torch/ops/`` names its library by a table
``_LIBRARY = (name, {entry: argtypes})``, the entry's arguments before the
stream that ``ops/_build.py:launch`` appends. ctypes trusts the table: a
count or a kind that the C entry does not have is read from the wrong
registers on the card, and nothing here would say so. So every entry of
every table must appear in ``csrc/<name>.cu`` as ``extern "C" int
<entry>(`` with as many parameters, each of the same kind, the stream last;
and every source must export ``azt_cuda_error_string``.
"""

import ctypes
import importlib
import pkgutil
import re

import pytest

from alpha_zero_tpu_torch import ops
from alpha_zero_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
_ERROR_STRING = re.compile(r'extern "C" const char\* azt_cuda_error_string\(int \w+\)')
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _tables():
    """Every ``_LIBRARY`` of the modules under ``ops/``, by library name."""
    tables = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        if hasattr(module, "_LIBRARY"):
            name, signatures = module._LIBRARY
            assert name not in tables, f"two wrappers name the library {name}"
            tables[name] = signatures
    return tables


def _kind(c_param: str):
    """The ctypes type a C parameter needs: "pointer" for any pointer."""
    if "*" in c_param:
        return "pointer"
    c_type = c_param.rsplit(None, 1)[0].replace("const ", "").strip()
    return _SCALARS[c_type]


def _declared_kind(argtype):
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return argtype


def test_every_source_has_one_table():
    assert sorted(_tables()) == _build.sources()


@pytest.mark.parametrize("name", _build.sources())
def test_table_entries_match_the_c_entries(name):
    source = (_build.CSRC_DIR / f"{name}.cu").read_text()
    entries = {e: [p.strip() for p in params.split(",")] for e, params in _ENTRY.findall(source)}
    assert _ERROR_STRING.search(source), f"{name}.cu does not export azt_cuda_error_string"
    signatures = _tables()[name]
    assert signatures
    for entry, argtypes in signatures.items():
        assert entry in entries, f'{name}.cu has no extern "C" int {entry}('
        c_params = entries[entry]
        assert len(c_params) == len(argtypes) + 1, (
            f"{entry}: the table has {len(argtypes)} arguments and the stream, "
            f"the C entry {len(c_params)} parameters")
        assert c_params[-1] == "void* stream", f"{entry} must take the stream last"
        for k, (c_param, argtype) in enumerate(zip(c_params, argtypes)):
            assert _declared_kind(argtype) == _kind(c_param), (
                f"{entry} argument {k}: the table has {argtype.__name__}, the C "
                f"entry {c_param!r}")
