"""Modules of ray_tpu that later slices of the port bring.

The copied runtime keeps ray_tpu's lazy imports pointed at the port's
own paths (``ray_tpu_torch.util.collective``, ...).
None of them is reached on the runtime's or the trainer's path.  Until
its slice lands, importing one raises an ImportError that names the
slice, instead of a bare "No module named ...".  The finder sits at the
END of ``sys.meta_path``, so it is asked only about modules no other
finder found.
"""

from __future__ import annotations

import importlib.abc
import sys
from typing import Dict

LIBRARIES = "the pure-Python libraries still to copy (ROADMAP A5)"

LATER: Dict[str, str] = {
    "ray_tpu_torch.util.collective": LIBRARIES,
    "ray_tpu_torch.util.state": LIBRARIES,
    "ray_tpu_torch._private.dashboard": LIBRARIES,
}


def unported(name: str) -> ImportError:
    """The error for ``name``, a module (or attribute) of a later slice."""
    for prefix, slice_name in LATER.items():
        if name == prefix or name.startswith(prefix + "."):
            return ImportError(
                f"{name} is not ported yet: it comes with {slice_name}",
                name=name)
    return ImportError(f"No module named {name!r}", name=name)


class _LaterSliceFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if any(fullname == p or fullname.startswith(p + ".") for p in LATER):
            raise unported(fullname)
        return None


def install() -> None:
    if not any(isinstance(f, _LaterSliceFinder) for f in sys.meta_path):
        sys.meta_path.append(_LaterSliceFinder())
