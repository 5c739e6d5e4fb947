"""GOOD: canonical keys via sorted iteration and a keyed digest."""
import hashlib


def canonical_key(dfg):
    return hashlib.sha256(repr(sorted(dfg.edges)).encode()).hexdigest()


def dfg_signature(dfg):
    parts = [str(n) for n in sorted({0, 1, 2})]
    for e in sorted(set(dfg.edges)):
        parts.append(str(e))
    return "|".join(parts)
