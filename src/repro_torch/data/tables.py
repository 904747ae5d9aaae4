"""Relational table abstraction (Definition 2.1): T = {C, S}."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence


@dataclass
class Table:
    name: str
    columns: List[str]                  # schema C
    rows: List[Dict[str, str]]          # rows S

    def __len__(self) -> int:
        return len(self.rows)

    def select(self, n: int, offset: int = 0) -> "Table":
        return Table(self.name, self.columns, self.rows[offset:offset + n])

    def column(self, name: str) -> List[str]:
        return [r[name] for r in self.rows]
