"""The port's ctypes table (``torchft_tpu_torch/_native.py``,
``_SIGNATURES``) held against the C API it binds
(``native/src/capi.cc``), through graftlint's own parser of that file
(``tools/graftlint/capi_sync.py``, ``parse_capi``).

ctypes has no compiler between the two: a parameter count or a return
width that drifts corrupts the call frame or truncates a pointer
silently. graftlint's ``capi_sync`` rule guards the JAX package's
binding; this is the same guard for the port's. Every C export is either
bound with a matching signature (name, parameter count, return kind) or
listed below as unbound on purpose, with the reason.
"""

import ctypes
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
# tools/ must outrank scripts/: scripts/graftlint.py (the CLI) would
# otherwise shadow the tools/graftlint package at import time.
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))

from graftlint.capi_sync import parse_capi  # noqa: E402

from torchft_tpu_torch._native import _SIGNATURES  # noqa: E402

# C exports the port leaves unbound, and why.
UNBOUND = {
    # every ring is configured through tft_hc_configure_hier, whose empty
    # region and host maps give the flat ring
    "tft_hc_configure": "configured through tft_hc_configure_hier",
    # a configure drops every plan of its handle (HostCollectives::configure
    # clears them) and the port rebuilds its plans per quorum; it never
    # frees one alone
    "tft_plan_free": "plans are dropped by the next configure",
    # the port keeps both on its side of the handle (HostCollectives
    # ._world_size, ._stripes)
    "tft_hc_world_size": "kept by the Python HostCollectives",
    "tft_hc_stripes": "kept by the Python HostCollectives",
}

# C return type -> the ctypes restype that reads it whole
_RETURNS = {
    "void": (None,),
    "int": (ctypes.c_int,),
    "int64_t": (ctypes.c_int64,),
    "uint32_t": (ctypes.c_uint32,),
}
_POINTER_RETURNS = (ctypes.c_void_p, ctypes.c_char_p)


@pytest.fixture(scope="module")
def exports():
    text = (REPO / "native" / "src" / "capi.cc").read_text()
    return {e.name: e for e in parse_capi(text)}


def test_every_export_bound_or_named(exports):
    bound = set(_SIGNATURES)
    assert len(exports) == 111
    assert sorted(bound - set(exports)) == []  # no binding dangles
    assert sorted(set(exports) - bound) == sorted(UNBOUND)
    assert len(bound) == 107


@pytest.mark.parametrize("name", sorted(_SIGNATURES))
def test_signature_matches_c(exports, name):
    export = exports[name]
    restype, argtypes = _SIGNATURES[name]
    assert len(argtypes) == export.nparams, (
        f"{name}: {len(argtypes)} argtypes, C takes {export.nparams} "
        f"(capi.cc:{export.line})")
    if "*" in export.ret:
        assert restype in _POINTER_RETURNS, (
            f"{name} returns {export.ret}: restype {restype} would truncate it")
    else:
        assert export.ret in _RETURNS, f"{name}: unknown C return {export.ret}"
        assert restype in _RETURNS[export.ret], (
            f"{name} returns {export.ret}, bound as {restype}")
