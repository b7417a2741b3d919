"""RDF term dictionary: strings <-> int64 ids, numeric literal values.

Spatial entities receive their (S, Z, I, L) ids from the S-QuadTree build;
everything else gets sequential non-spatial ids (S bit clear). Numeric
literals keep a side table id -> float used by ranking functions. Following
RDF-3X, the query engine never touches strings on the hot path.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dictionary:
    term_to_id: dict
    id_to_term: dict
    numeric_value: dict            # id -> float
    _next: int = 1                 # 0 reserved as NULL

    @staticmethod
    def empty() -> "Dictionary":
        return Dictionary({}, {}, {})

    def intern(self, term: str) -> int:
        i = self.term_to_id.get(term)
        if i is not None:
            return i
        i = self._next
        self._next += 1
        self.term_to_id[term] = i
        self.id_to_term[i] = term
        if _is_number(term):
            self.numeric_value[i] = float(term)
        return i

    def intern_numeric(self, value: float) -> int:
        return self.intern(repr(float(value)))

    def remap(self, mapping: dict) -> None:
        """Apply id remapping (plain id -> spatial id) after the tree build."""
        new_t2i, new_i2t, new_num = {}, {}, {}
        for t, i in self.term_to_id.items():
            j = mapping.get(i, i)
            new_t2i[t] = j
            new_i2t[j] = t
            if i in self.numeric_value:
                new_num[j] = self.numeric_value[i]
        self.term_to_id, self.id_to_term = new_t2i, new_i2t
        self.numeric_value = new_num

    def lookup(self, i: int) -> str:
        return self.id_to_term.get(int(i), f"_:id{int(i)}")

    def __len__(self) -> int:
        return len(self.term_to_id)


def _is_number(term: str) -> bool:
    try:
        float(term)
        return True
    except ValueError:
        return False
