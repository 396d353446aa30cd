"""Immutable label vocabulary shared by every pipeline stage.

The reference rebuilt ``class_to_idx`` from whatever classes happened to be
present in each split (reference ``Utils.py:61-65``), so a val/test/adversarial
split missing a class silently disagreed with the training-time mapping. Here
the vocabulary is constructed once (sorted union over splits, matching
reference ``train.py:158-163``), frozen, and serialised to the same
``class_mappings.txt`` format (``"{idx}: {name}"`` per line, reference
``train.py:216-219``) so artifacts interoperate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence


@dataclass(frozen=True)
class LabelVocabulary:
    """Frozen ``name <-> index`` mapping over unified class names."""

    classes: tuple[str, ...]
    _index: Mapping[str, int] = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if len(set(self.classes)) != len(self.classes):
            raise ValueError("duplicate class names in vocabulary")
        object.__setattr__(self, "_index", {c: i for i, c in enumerate(self.classes)})

    # -- construction ------------------------------------------------------
    @classmethod
    def from_classes(cls, names: Iterable[str]) -> "LabelVocabulary":
        """Sorted, deduplicated vocabulary — the canonical constructor."""
        return cls(tuple(sorted(set(names))))

    @classmethod
    def from_metadata_frames(cls, frames: Sequence) -> "LabelVocabulary":
        """Union of ``unified_class`` columns over any number of DataFrames."""
        names: set[str] = set()
        for df in frames:
            if df is not None and len(df):
                names.update(map(str, df["unified_class"].unique()))
        return cls.from_classes(names)

    # -- mapping -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.classes)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def index_of(self, name: str) -> int:
        try:
            return self._index[name]
        except KeyError:
            raise KeyError(f"class {name!r} not in vocabulary {self.classes}") from None

    def name_of(self, idx: int) -> str:
        return self.classes[idx]

    def encode(self, names: Iterable[str]) -> list[int]:
        return [self.index_of(n) for n in names]

    @property
    def class_to_idx(self) -> dict[str, int]:
        return dict(self._index)

    # -- persistence (reference-compatible format) --------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for idx, name in enumerate(self.classes):
                f.write(f"{idx}: {name}\n")

    @classmethod
    def load(cls, path: str) -> "LabelVocabulary":
        """Parse ``class_mappings.txt`` (``"{idx}: {name}"``, any line order)."""
        pairs: list[tuple[int, str]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                idx_str, name = line.split(": ", 1)
                pairs.append((int(idx_str), name))
        pairs.sort()
        if [i for i, _ in pairs] != list(range(len(pairs))):
            raise ValueError(f"non-contiguous class indices in {path}")
        return cls(tuple(name for _, name in pairs))
