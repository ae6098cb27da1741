"""Vocabulary (id-map) loading.

Reference semantics: ``loadIdFile`` (``common/loader.cpp:15-24``) reads
whitespace-separated ``<name> <int id>`` pairs into a map.  The reference then
*trusts* the contract "ids start at 0 and have no holes" (``README.md:4``,
``numEntities_ = entity2id.size()`` at ``common/trainer.cpp:196-197``); we
validate it explicitly (survey quirk B13).
"""

from __future__ import annotations

import os
from typing import Dict


def load_id_file(path: str, *, validate: bool = True) -> Dict[str, int]:
    """Load a ``name<TAB>id`` vocabulary file.

    Like the reference's fscanf("%s\t%d") loop, tokens are split on any
    whitespace; a line that does not parse raises instead of ending the scan.
    """
    id_map: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"{path}:{lineno}: expected '<name> <id>', got {line!r}")
            name, raw_id = parts
            id_map[name] = int(raw_id)

    if validate:
        validate_contiguous(id_map, path)
    return id_map


def validate_contiguous(id_map: Dict[str, int], origin: str = "<id map>") -> None:
    """Enforce the "ids start at 0 and have no holes" contract (README.md:4)."""
    n = len(id_map)
    ids = sorted(id_map.values())
    if ids != list(range(n)):
        missing = sorted(set(range(n)) - set(ids))[:5]
        raise ValueError(
            f"{origin}: ids must be exactly 0..{n - 1} with no holes/duplicates "
            f"(first problems: {missing or ids[:5]})"
        )


def write_id_file(path: str, id_map: Dict[str, int]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for name, i in sorted(id_map.items(), key=lambda kv: kv[1]):
            f.write(f"{name}\t{i}\n")
