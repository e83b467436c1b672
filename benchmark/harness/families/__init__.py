"""The program's side of each decode family, `harness/families/<name>.py`,
found by the family's name (`reference.models.family`): it gives

    decode_call(run) -> a call of no arguments that runs the port's
                        decoder for the family once, on the forward's maps
                        of one of the cell's inputs (what
                        `postproc.decode_device_ms.*` and the decode's
                        spans time)

and imports the program only inside its functions."""

from __future__ import annotations

import importlib
import types

from reference import models


def of(model: dict) -> types.ModuleType:
    """The harness family of the configuration's network."""
    name = models.network(model["name"]).FAMILY
    return importlib.import_module(f"harness.families.{name}")
