"""Byte-level tokenization (port of ``encode_bytes`` / ``decode_bytes``
from ``k8s_tpu/models/dataset.py``; the token-shard reader comes with
training)."""

from __future__ import annotations

import numpy as np


def encode_bytes(text: bytes | str) -> np.ndarray:
    """Byte-level tokenization: vocab 256, identity over raw bytes."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, dtype=np.uint8).astype(np.uint16)


def decode_bytes(tokens: np.ndarray) -> str:
    return bytes(np.asarray(tokens, dtype=np.uint8)).decode(
        "utf-8", errors="replace")
