"""Shared constants of the framework.

Mirrors the reference's ``common/constants.h:1-56`` contract: method ids,
distance ids, dataset file names, output basenames, and defaults.  These are
the *interop surface* — the values must match the reference exactly so that
data directories and embedding files are interchangeable between the
reference binaries, ``kb2e_tpu`` and this package.
"""

from __future__ import annotations

import enum


class Method(enum.IntEnum):
    """Negative-sampling strategy (reference ``common/constants.h:8-9``)."""

    UNIF = 0
    BERN = 1

    @property
    def tag(self) -> str:
        # METHOD_TO_STRING, common/constants.h:14
        return "unif" if self is Method.UNIF else "bern"

    @classmethod
    def from_any(cls, v: "int | str | Method") -> "Method":
        if isinstance(v, Method):
            return v
        if isinstance(v, str):
            s = v.strip().lower()
            if s in ("unif", "0"):
                return cls.UNIF
            if s in ("bern", "1"):
                return cls.BERN
            raise ValueError(f"unknown method: {v!r}")
        return cls(int(v))


class Distance(enum.IntEnum):
    """Distance flavour (reference ``common/constants.h:16-17``)."""

    L1 = 0
    L2 = 1

    @classmethod
    def from_any(cls, v: "int | str | Distance") -> "Distance":
        if isinstance(v, Distance):
            return v
        if isinstance(v, str):
            s = v.strip().lower()
            if s in ("l1", "0"):
                return cls.L1
            if s in ("l2", "1"):
                return cls.L2
            raise ValueError(f"unknown distance: {v!r}")
        return cls(int(v))


# Dataset file names (common/constants.h:19-23).
ENTITY_ID_FILE = "entity2id.txt"
RELATION_ID_FILE = "relation2id.txt"
TRAIN_FILE = "train.txt"
TEST_FILE = "test.txt"
VALID_FILE = "valid.txt"

# Output basenames (common/constants.h:24-26).
ENTITY_EMBEDDING_BASENAME = "entity2vec"
RELATION_EMBEDDING_BASENAME = "relation2vec"
WEIGHT_EMBEDDING_BASENAME = "weights"

# Defaults (common/constants.h:28-40).
DEFAULT_EMBEDDING_SIZE = 100
DEFAULT_LEARNING_RATE = 0.001
DEFAULT_MARGIN = 1.0
DEFAULT_METHOD = Method.BERN
DEFAULT_NUM_BATCHES = 100
DEFAULT_MAX_EPOCHS = 1000
DEFAULT_DISTANCE = Distance.L1
DEFAULT_SEED_DATA_DIR = "."
DEFAULT_SEED_METHOD = Method.UNIF
DEFAULT_DATA_DIR = "../data"
DEFAULT_OUTPUT_DIR = "."
