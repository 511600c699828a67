"""A configuration's ``switches``: module flags of the port, such as
``{"render.lights.NEE_CLOSEST_SHADOW": true}``, each named by its module
under the package and its attribute. The run sets each one on both sides
before anything is loaded: under the port (``harness/port.py::PACKAGE``)
and under the reference (``reference/side.py::PACKAGE``), which has the
same modules. A name that either side lacks fails the run."""

from __future__ import annotations

import importlib


def set_switches(package: str, switches: dict) -> dict:
    """Set each switch under ``package``; returns the values they had."""
    before = {}
    for name, value in (switches or {}).items():
        module, _, attr = name.rpartition(".")
        try:
            mod = importlib.import_module(f"{package}.{module}")
        except ModuleNotFoundError:
            mod = None
        if not module or mod is None or not hasattr(mod, attr):
            raise ValueError(f"unknown switch {name!r}: no {attr} in {package}.{module}")
        before[name] = getattr(mod, attr)
        setattr(mod, attr, value)
    return before


def set_both(port, ref, switches: dict):
    """Set the switches under the port and under the reference."""
    for side in (port, ref):
        set_switches(side.PACKAGE, switches)
