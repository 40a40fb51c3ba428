"""Debug-by-inspection helpers (reference ``structure.py:258-302``).

Counterpart of ``mfcd_tpu/utils/debug.py``, copied."""

from __future__ import annotations


def print_return_structure_types(obj, prefix: str = "root") -> None:
    """Recursively print the type structure of a nested results object.

    Matches the reference's debugging helper: dicts recurse, lists/tuples
    report their element type (or 'mixed'/'[empty]'), arrays report their
    type name, scalars report the python type.
    """
    if isinstance(obj, dict):
        for k, v in obj.items():
            print_return_structure_types(v, f"{prefix}.{k}")
    elif isinstance(obj, (list, tuple)):
        if len(obj) == 0:
            print(f"{prefix}: {type(obj).__name__}[empty]")
        else:
            inner_types = {type(el).__name__ for el in obj}
            if len(inner_types) == 1:
                print(f"{prefix}: {type(obj).__name__}[{next(iter(inner_types))}]")
            else:
                print(f"{prefix}: {type(obj).__name__}[mixed]")
    else:
        type_name = type(obj).__name__
        module = type(obj).__module__
        if module not in ("builtins",):
            type_name = f"{module}.{type_name}"
        print(f"{prefix}: {type_name}")
