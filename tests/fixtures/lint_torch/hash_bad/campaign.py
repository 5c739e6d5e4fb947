"""BAD: canonical keys built from salted hash() / set iteration order."""


def canonical_key(dfg):
    return hash(tuple(dfg.edges))


def dfg_signature(dfg):
    parts = [str(n) for n in {0, 1, 2}]
    for e in set(dfg.edges):
        parts.append(str(e))
    return "|".join(parts)
