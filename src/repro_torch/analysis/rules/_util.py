"""Shared helpers for lint rules."""
from __future__ import annotations

import ast


def snippet(node: ast.AST, limit: int = 60) -> str:
    """Stable short rendering of a node for fingerprints/messages."""
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.10+
        text = type(node).__name__
    text = " ".join(text.split())
    return text if len(text) <= limit else text[: limit - 3] + "..."
